"""Attention entry points that route by tensor device.

A CUDA tensor launches the hand-written Hopper kernel (or the wrapper
raises); a CPU tensor takes the kernel's plain version from ``ref.py``.
There is no fallback from one to the other. The reference routes by JAX
backend instead (interpret mode on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"attention kernels run on cuda or cpu tensors, not {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q [B, S, H, D]; k, v [B, S, Hkv, D] -> [B, S, H, D]."""
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, valid_mask):
    """q [B, 1, H, D]; k, v [B, C, Hkv, D]; valid_mask [B, C] -> [B, 1, H, D].

    q in bf16 over an f32 cache is what a step with bf16 weights hands over
    (the cache stays in the config's dtype, as the reference builds it): q is
    widened to f32, which is exact, the attention runs in f32 and the output
    takes q's dtype, as the Pallas kernel computes it. Any other mix raises;
    the [B, C, Hkv, D] cache is never cast."""
    out_dtype = q.dtype
    if q.dtype != k.dtype or q.dtype != v.dtype:
        if not (q.dtype == torch.bfloat16 and k.dtype == v.dtype == torch.float32):
            raise ValueError(f"decode_attention takes q, k, v of one dtype or bf16 q "
                             f"over f32 k/v, got q {q.dtype}, k {k.dtype}, v {v.dtype}")
        q = q.to(torch.float32)
    if _on_cuda(q):
        out = _da.decode_attention(q, k, v, valid_mask)
    else:
        out = ref.decode_attention_ref(q, k, v, valid_mask)
    return out.to(out_dtype)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {"flash_attention": _fa.launches, "decode_attention": _da.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _da.launches = 0
