"""Normalisation layers. Both compute in float32 (float64 for a float64
input) and cast back to the input dtype, as the reference does. RMSNorm's eps is the reference's 1e-6 (not
llama's published 1e-5); LayerNorm uses the population variance.

``rmsnorm_block`` is the RMSNorm of a last dim that a rank of a running
mesh holds a block of over "model" (Mamba2's and the mLSTM's gated norms
over ``d_inner``, whose channels the rank computes): the sum of squares is
summed over "model" before the rank scales its block with its slice of
the whole gain."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import collectives as col
from repro_torch.kernels.ref import acc_dtype


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                              requires_grad=False)

    def forward(self, x):
        return rmsnorm(self, x)


def rmsnorm(params: RMSNorm, x, *, eps: float = 1e-6):
    dt, acc = x.dtype, acc_dtype(x)
    x32 = x.to(acc)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * (1.0 / torch.sqrt(var + eps))
    return (y * params.g.to(acc)).to(dt)


def rank_slice(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This rank's ``n``-wide slice along ``dim`` of a tensor every rank of
    "model" holds whole and uses for its own block (a whole parameter, or
    a gathered activation): ``t`` passes through ``collectives.copy``, so
    the ranks' parts of its gradient are summed."""
    if n == t.shape[dim]:
        return t
    return col.copy(t, "model").narrow(dim, col.index("model") * n, n)


def rmsnorm_block(params: RMSNorm, x, dim: int, *, eps: float = 1e-6):
    """``rmsnorm`` over a last dim of ``dim`` of which ``x`` holds this
    rank's block over "model" (all of it off a mesh): the block's sum of
    squares is summed over "model", then the block is scaled by its slice
    of the gain ``g`` [dim]."""
    if x.shape[-1] == dim:
        return rmsnorm(params, x, eps=eps)
    dt, acc = x.dtype, acc_dtype(x)
    x32 = x.to(acc)
    # the sum is used by each rank for its own block: copy sums its gradient back
    ss = col.copy(col.psum(torch.sum(x32 * x32, dim=-1, keepdim=True), "model"), "model")
    y = x32 * (1.0 / torch.sqrt(ss / dim + eps))
    return (y * rank_slice(params.g, 0, x.shape[-1]).to(acc)).to(dt)


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
    dt, acc = x.dtype, acc_dtype(x)
    x32 = x.to(acc)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) / torch.sqrt(var + eps)
    return (y * params.g.to(acc) + params.b.to(acc)).to(dt)
