"""Normalisation layers. Both compute in float32 and cast back to the input
dtype, as the reference does. RMSNorm's eps is the reference's 1e-6 (not
llama's published 1e-5); LayerNorm uses the population variance."""
from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                              requires_grad=False)

    def forward(self, x):
        return rmsnorm(self, x)


def rmsnorm(params: RMSNorm, x, *, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * (1.0 / torch.sqrt(var + eps))
    return (y * params.g.to(torch.float32)).to(dt)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device),
                              requires_grad=False)

    def forward(self, x):
        return layernorm(self, x)


def layernorm(params: LayerNorm, x, *, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) / torch.sqrt(var + eps)
    return (y * params.g.to(torch.float32) + params.b.to(torch.float32)).to(dt)
