"""Rotary position embeddings: half-split rotation (the head dim is split
into two halves, not interleaved pairs), angles in float32 from integer
positions; the rotation in float32 (float64 for a float64 input)."""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import acc_dtype


def rope_frequencies(head_dim: int, *, theta: float = 10000.0, device="cpu"):
    """Inverse frequencies [head_dim//2], float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x, positions, inv_freq):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] int."""
    dt = x.dtype
    # angles [..., seq, head_dim//2]
    ang = positions.to(torch.float32)[..., None] * inv_freq
    cos = torch.cos(ang)[..., None, :]   # [..., seq, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x32 = x.to(acc_dtype(x))
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)
