"""AdamW and global-norm gradient clipping over a module's parameters.

Written out rather than taken from ``torch.optim`` so that the arithmetic is
the reference's (``repro/train/optim.py``) step for step: f32 moments, bias
corrections ``1 - b**t`` with ``t`` in f32, ``(m/bc1) / (sqrt(v/bc2) + eps)``
and the decay ``p - lr * (update + wd * p)``; and so that ``lr`` can change
on every call (the predictor's cosine schedule).

Moments and gradients are dicts keyed by parameter name
(``module.named_parameters()``); ``step`` is a Python int, so an update
never reads a value back from the device.
"""
from __future__ import annotations

import numpy as np  # reprolint: ignore[RPL002] host-side f32 bias corrections of the step count only
import torch
from torch import nn


def adamw_init(params: nn.Module) -> dict:
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.named_parameters()}
    return {"m": zeros, "v": {n: z.clone() for n, z in zeros.items()}, "step": 0}


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """Scale ``grads`` so their joint L2 norm is at most ``max_norm``.
    Returns (clipped grads, norm before clipping) without a host sync."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads.values()))
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
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    lr = float(np.float32(lr))
    new_m, new_v = {}, {}
    for n, p in params.named_parameters():
        g32 = grads[n].to(torch.float32)
        m = b1 * state["m"][n] + (1 - b1) * g32
        v = b2 * state["v"][n] + (1 - b2) * g32 * g32
        update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.to(torch.float32)
        p.copy_((p32 - lr * (update + weight_decay * p32)).to(p.dtype))
        new_m[n], new_v[n] = m, v
    return params, {"m": new_m, "v": new_v, "step": step}
