"""Residual MLP blocks — the paper's feature-extraction module (§IV-C: "Raw
data ... undergoes processing through a fully connected layer to reduce
dimensionality ... refined through several residual blocks")."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.linear import Linear, linear
from repro_torch.nn.norms import LayerNorm, layernorm


class ResBlock(nn.Module):
    """LayerNorm -> fc1 -> ReLU -> fc2, added to the input."""

    def __init__(self, dim: int, *, dtype=torch.float32, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln = LayerNorm(dim, **kw)
        self.fc1 = Linear(dim, dim, bias=True, generator=generator, **kw)
        self.fc2 = Linear(dim, dim, bias=True, generator=generator, **kw)

    def forward(self, x):
        return resblock(self, x)


def resblock(params: ResBlock, x):
    h = layernorm(params.ln, x)
    h = F.relu(linear(params.fc1, h))
    h = linear(params.fc2, h)
    return x + h


class ResMLP(nn.Module):
    """``proj`` (in_dim -> dim, then ReLU) followed by ``n_blocks`` ResBlocks."""

    def __init__(self, in_dim: int, dim: int, n_blocks: int, *,
                 dtype=torch.float32, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.proj = Linear(in_dim, dim, bias=True, **kw)
        self.blocks = nn.ModuleList(ResBlock(dim, **kw) for _ in range(n_blocks))

    def forward(self, x):
        return res_mlp(self, x)


def res_mlp(params: ResMLP, x):
    h = F.relu(linear(params.proj, x))
    for bp in params.blocks:
        h = resblock(bp, h)
    return h
