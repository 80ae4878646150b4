"""Feed-forward blocks: SwiGLU (llama-style) and GELU (whisper/gpt-style).

The GELU is the tanh approximation, as ``jax.nn.gelu``'s default; torch's
default exact GELU would not match the reference. Under a running mesh
the up projections may hold a column block of d_ff and the down
projection the matching row block (``linear_rows`` sums over "model");
the input then passes through ``collectives.copy``, so its gradient is
summed over "model"."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as col
from repro_torch.nn.linear import Linear, linear, linear_rows


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, *, kind: str = "swiglu",
                 dtype=torch.float32, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.kind = kind
        self.hidden = hidden
        if kind == "swiglu":
            self.wg = Linear(dim, hidden, **kw)
            self.wu = Linear(dim, hidden, **kw)
            self.wd = Linear(hidden, dim, **kw)
        else:
            self.w1 = Linear(dim, hidden, bias=True, **kw)
            self.w2 = Linear(hidden, dim, bias=True, **kw)

    def forward(self, x):
        return mlp(self, x, kind=self.kind)


def mlp(params: MLP, x, *, kind: str = "swiglu"):
    up = params.wg if kind == "swiglu" else params.w1
    if up.w.shape[1] < params.hidden:           # a column block of d_ff
        x = col.copy(x, "model")
    if kind == "swiglu":
        g = linear(params.wg, x)
        u = linear(params.wu, x)
        return linear_rows(params.wd, F.silu(g) * u, params.hidden)
    h = F.gelu(linear(params.w1, x), approximate="tanh")
    return linear_rows(params.w2, h, params.hidden)
