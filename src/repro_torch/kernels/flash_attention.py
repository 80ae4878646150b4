"""Flash attention (prefill) — the hand-written Hopper CUDA kernel.

Port of ``repro/kernels/flash_attention.py`` (Pallas TPU). The kernel source
is ``csrc/flash_attention.cu``; its header says what bounds it on the H100
and how the design answers. This wrapper takes CUDA tensors only: it checks
them, allocates the output, launches on the current stream without
synchronising and counts the launch in ``launches``. The plain version is
``kernels.ref.flash_attention_ref``; ``kernels.ops`` picks between the two by
tensor device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0            # incremented once per successful kernel launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, P]
    lib.flash_attention_fwd.restype = I
    return lib


def _check_inputs(q, k, v):
    """Raise on what the kernel does not take; returns (B, S, H, Hkv, D)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel takes CUDA tensors only; "
                         "kernels.ops routes CPU tensors to the plain version")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one of "
                         f"{sorted(str(d) for d in _DTYPE_CODES)} for all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need q [B,S,H,D], k = v [B,S,Hkv,D]")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not 0 < D <= 128:
        raise ValueError(f"head_dim {D} outside the kernel's range 1..128")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    return B, S, H, Hkv, D


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q [B, S, H, D]; k, v [B, S, Hkv, D] (CUDA) -> [B, S, H, D]."""
    global launches
    B, S, H, Hkv, D = _check_inputs(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, Hkv, D, int(causal), window or 0, _DTYPE_CODES[q.dtype],
            stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
