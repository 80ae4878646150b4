"""Attention entry points that route by tensor device.

A CUDA tensor launches the hand-written Hopper kernel (or the wrapper
raises); a CPU tensor takes the kernel's plain version from ``ref.py``.
There is no fallback from one to the other. The reference routes by JAX
backend instead (interpret mode on the CPU).
"""
from __future__ import annotations

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
    """q [B, 1, H, D]; k, v [B, C, Hkv, D]; valid_mask [B, C] -> [B, 1, H, D]."""
    if _on_cuda(q):
        return _da.decode_attention(q, k, v, valid_mask)
    return ref.decode_attention_ref(q, k, v, valid_mask)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {"flash_attention": _fa.launches, "decode_attention": _da.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _da.launches = 0
