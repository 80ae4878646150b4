"""GQA single-token decode attention — the hand-written Hopper CUDA kernel.

Port of ``repro/kernels/decode_attention.py`` (Pallas TPU). The kernel
source is ``csrc/decode_attention.cu``; its header says what bounds it on
the H100 and how the design answers. This wrapper takes CUDA tensors only:
it checks them, allocates the output, launches on the current stream without
synchronising and counts the launch in ``launches``. The plain version is
``kernels.ref.decode_attention_ref``; ``kernels.ops`` picks between the two
by tensor device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0            # incremented once per successful kernel launch

MAX_GROUP_DIM = 2048    # g * D the kernel holds in registers (256 threads x 8)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    lib = build.load("decode_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.decode_attention_fwd.restype = I
    return lib


def _check_inputs(q, k, v, valid_mask):
    """Raise on what the kernel does not take; returns (B, C, H, Hkv, D)."""
    ts = (q, k, v, valid_mask)
    if not all(t.is_cuda for t in ts):
        raise ValueError("decode_attention kernel takes CUDA tensors only; "
                         "kernels.ops routes CPU tensors to the plain version")
    if len({t.device for t in ts}) != 1:
        raise ValueError("q, k, v and valid_mask must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need one of "
                         f"{sorted(str(d) for d in _DTYPE_CODES)} for all three")
    if valid_mask.dtype != torch.bool:
        raise ValueError(f"valid_mask must be bool, got {valid_mask.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need q [B,1,H,D], k = v [B,C,Hkv,D]")
    B, _, H, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if tuple(valid_mask.shape) != (B, C):
        raise ValueError(f"valid_mask {tuple(valid_mask.shape)} is not [B, C] = {(B, C)}")
    if (H // Hkv) * D > MAX_GROUP_DIM:
        raise ValueError(f"group {H // Hkv} x head_dim {D} exceeds {MAX_GROUP_DIM}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("decode_attention kernel needs contiguous inputs")
    return B, C, H, Hkv, D


def decode_attention(q, k, v, valid_mask):
    """q [B, 1, H, D]; k, v [B, C, Hkv, D]; valid_mask [B, C] bool (CUDA)
    -> [B, 1, H, D]."""
    global launches
    B, C, H, Hkv, D = _check_inputs(q, k, v, valid_mask)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_mask.data_ptr(),
            out.data_ptr(), B, C, H, Hkv, D, _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
