"""Linear / embedding primitives.

The weight keeps the reference layout ``[in, out]`` (``y = x @ w``), so the
JAX parameter pytree copies across without a transpose.

Under a running mesh (``distributed.collectives``) a rank may hold a block
of a weight over "model", as ``distributed.sharding``'s rules place it.
``linear`` on a column block (``w [in, out/M]``) gives the rank's block of
the output's last dim; ``linear_rows`` takes a row block (``w [in/M, out]``,
row parallel): it multiplies the matching block of the input and sums the
partial products over "model" before the bias. ``embedding`` looks up a
vocab block (rows of ``e``) or a width block (columns) and returns the
whole embedding. Weights held whole take the single-device path.

Under grad the collectives carry their transposes
(``distributed.collectives``): a column block's input passes through
``copy`` (its gradient is summed over "model"), the row block's partial
products through ``psum``, and ``linear_shared`` applies a whole weight
that each rank of "model" uses for its own heads.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import collectives as col


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


def linear_rows(params: Linear, x, in_dim: int):
    """``linear`` of a weight whose ``in_dim`` rows may be this rank's
    block over "model": ``x`` holds the matching block of its last dim (or
    all ``in_dim``, and is cut to the block); the partial products are
    summed over "model", then the bias is added once."""
    w = params.w
    if w.shape[0] == in_dim:
        return linear(params, x)
    if x.shape[-1] == in_dim:
        x = col.block(x, "model", -1)
    y = col.psum(x @ w.to(x.dtype), "model")
    if params.b is not None:
        y = y + params.b.to(x.dtype)
    return y


def linear_cols(params: Linear, x, out_dim: int, *, gather: bool = True):
    """``linear`` whose ``out_dim`` columns may be this rank's block over
    "model"; the blocks are gathered into the whole output (or, with
    ``gather=False``, the rank's block of it is returned)."""
    if params.w.shape[1] == out_dim:
        return linear(params, x)
    y = linear(params, col.copy(x, "model"))
    return col.gather(y, "model", -1) if gather else y


def linear_shared(params: Linear, x):
    """``linear`` of a whole weight that each rank of "model" applies in its
    own way (the kv heads a rank's query block uses): its gradient is
    summed over "model"."""
    y = x @ col.copy(params.w, "model").to(x.dtype)
    if params.b is not None:
        y = y + col.copy(params.b, "model").to(x.dtype)
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


def embedding(params: Embedding, tokens, vocab: int | None = None,
              dim: int | None = None):
    """Rows of ``e`` for ``tokens``. Given the whole table's ``vocab`` and
    ``dim``, a rank holding a block of ``e`` over "model" returns the whole
    embedding: a vocab block looks up the tokens in its range (zeros
    elsewhere) and the blocks are summed; a width block is gathered."""
    e = params.e
    if vocab is not None and e.shape[0] < vocab:
        lo = col.index("model") * e.shape[0]
        local = tokens - lo
        hit = (local >= 0) & (local < e.shape[0])
        rows = e[local.clamp(0, e.shape[0] - 1)] * hit[..., None].to(e.dtype)
        return col.psum(rows, "model")
    if dim is not None and e.shape[1] < dim:
        return col.gather(e[tokens], "model", -1)
    return e[tokens]
