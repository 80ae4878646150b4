"""AdamW and global-norm gradient clipping over a module's parameters.

Written out rather than taken from ``torch.optim`` so that the arithmetic is
the reference's (``repro/train/optim.py``) step for step: f32 moments, bias
corrections ``1 - b**t`` with ``t`` in f32, ``(m/bc1) / (sqrt(v/bc2) + eps)``
and the decay ``p - lr * (update + wd * p)``; and so that ``lr`` can change
on every call (the predictor's cosine schedule).

Moments and gradients are dicts keyed by parameter name
(``module.named_parameters()``); ``step`` is a Python int, so an update
never reads a value back from the device.

On a running mesh (``distributed.collectives``) the parameters are the
rank's blocks. ``clip_by_global_norm`` given ``split`` (name -> the axes a
parameter's block is split over) sums each block's squares over those
axes, so a replicated parameter counts once. ZeRO-1: ``adamw_init`` given
``zero`` (``distributed.sharding.zero_layout``: name -> (dim, axes,
parts)) makes each moment the rank's block of its parameter's block along
``dim`` over ``axes``, and ``adamw_update`` updates that block of the
parameter with it, then gathers the parameter over ``axes``: the same
arithmetic, element by element, as the whole update.
"""
from __future__ import annotations

import numpy as np  # reprolint: ignore[RPL002] host-side f32 bias corrections of the step count only
import torch
from torch import nn

from repro_torch.distributed import collectives as col


def adamw_init(params: nn.Module, *, zero: dict | None = None) -> dict:
    """Zero f32 moments; with ``zero`` (module docstring) each listed
    moment is the rank's block, and the state keeps the layout."""
    zeros = {}
    for n, p in params.named_parameters():
        shape = list(p.shape)
        if zero and n in zero:
            dim, _, parts = zero[n]
            shape[dim] //= parts
        zeros[n] = torch.zeros(shape, dtype=torch.float32, device=p.device)
    state = {"m": zeros, "v": {n: z.clone() for n, z in zeros.items()}, "step": 0}
    if zero:
        state["zero"] = dict(zero)
    return state


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float, *,
                        split: dict | None = None):
    """Scale ``grads`` so their joint L2 norm is at most ``max_norm``.
    Returns (clipped grads, norm before clipping) without a host sync.
    ``split`` (module docstring) makes it the norm of the whole gradient
    of which ``grads`` are this rank's blocks."""
    if split is None:
        sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads.values())
    else:
        by_axes = {}
        for n, g in grads.items():
            axes = tuple(split.get(n, ()))
            by_axes[axes] = by_axes.get(axes, 0.0) + torch.sum(torch.square(
                g.to(torch.float32)))
        sq = sum(col.psum(part, axes) for axes, part in by_axes.items())
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return {n: (g.to(torch.float32) * scale).to(g.dtype)
            for n, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(params: nn.Module, grads: dict[str, torch.Tensor], state: dict, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01):
    """One AdamW step. Updates ``params`` in place and returns
    ``(params, new_state)``, as the reference returns its new pytrees."""
    step = state["step"] + 1
    zero = state.get("zero") or {}
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    lr = float(np.float32(lr))
    new_m, new_v = {}, {}
    for n, p in params.named_parameters():
        g32, mine = grads[n].to(torch.float32), p
        if n in zero:                       # ZeRO-1: the moment's block of p
            dim, axes, _ = zero[n]
            g32, mine = col.block(g32, axes, dim), col.block(p, axes, dim)
            if g32.shape != state["m"][n].shape:
                raise ValueError(f"{n}: a ZeRO moment {tuple(state['m'][n].shape)} outside "
                                 f"its mesh (collectives.use_mesh) or on another one")
        m = b1 * state["m"][n] + (1 - b1) * g32
        v = b2 * state["v"][n] + (1 - b2) * g32 * g32
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = mine.to(torch.float32)
        new = (p32 - lr * (update + weight_decay * p32)).to(p.dtype)
        p.copy_(col.gather(new, axes, dim) if n in zero else new)
        new_m[n], new_v[n] = m, v
    out = {"m": new_m, "v": new_v, "step": step}
    if zero:
        out["zero"] = zero
    return params, out
