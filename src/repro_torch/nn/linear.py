"""Linear / embedding primitives.

The weight keeps the reference layout ``[in, out]`` (``y = x @ w``), so the
JAX parameter pytree copies across without a transpose."""
from __future__ import annotations

import torch
from torch import nn


def _normal(shape, *, std: float, dtype, device, generator) -> nn.Parameter:
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32).mul_(std)
    return nn.Parameter(w.to(dtype), requires_grad=False)


class Linear(nn.Module):
    """Lecun-normal weight ``w [in, out]`` (+ optional zero bias ``b``)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 dtype=torch.float32, scale: float | None = None,
                 device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        if scale is None:
            scale = 1.0 / (in_dim ** 0.5)
        self.w = _normal((in_dim, out_dim), std=scale, dtype=dtype,
                         device=device, generator=generator)
        self.b = (nn.Parameter(torch.zeros(out_dim, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)

    def forward(self, x):
        return linear(self, x)


def linear(params: Linear, x):
    y = x @ params.w.to(x.dtype)
    if params.b is not None:
        y = y + params.b.to(x.dtype)
    return y


class Embedding(nn.Module):
    """Token table ``e [vocab, dim]``, normal with std 0.02."""

    def __init__(self, vocab: int, dim: int, *, dtype=torch.float32,
                 device="cpu", generator: torch.Generator | None = None):
        super().__init__()
        self.e = _normal((vocab, dim), std=0.02, dtype=dtype, device=device,
                         generator=generator)

    def forward(self, tokens):
        return embedding(self, tokens)


def embedding(params: Embedding, tokens):
    return params.e[tokens]
