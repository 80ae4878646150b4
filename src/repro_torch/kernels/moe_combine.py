"""Gated combine of a MoE layer — the hand-written Hopper CUDA kernel.

Replaces no TPU kernel: the JAX package's MoE is plain ``jnp``
(``repro/nn/moe.py``), and the port's combine was a float32 ``[B, E, S,
d]`` scatter-and-sum buffer. The source is ``csrc/moe_combine.cu``; its
header says what bounds it on the H100 and how the design answers. This
wrapper takes CUDA tensors only: it checks them, allocates the output,
launches on the current stream without synchronising and counts the launch
in ``launches``. ``combine`` is the differentiable entry: a
``torch.autograd.Function`` whose backward is plain PyTorch
(``kernels.ref.moe_combine_grad``). The plain version is
``kernels.ref.moe_combine_ref``; ``kernels.ops`` picks between the two by
tensor device.

A block owns ``tok`` tokens of one row (``plan_tokens``: 16, halved while
the grid holds fewer than two blocks an SM and while the block's shared
memory, 16 bytes an expert a token, would pass 48 KB), reads only the slots
that hold one of its tokens and writes each output element once.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

launches = 0            # incremented once per successful kernel launch

NT = 256                # threads per block
MAX_TOK = 16            # tokens per block
SMEM_LIMIT = 48 * 1024  # the static shared-memory limit, no opt-in needed
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(E: int, tok: int) -> int:
    """Shared memory of a block (``csrc/moe_combine.cu``'s ``smem_bytes``)."""
    return E * (tok | 1) * 4 + tok * E * 12 + tok * 4


def plan_tokens(B: int, S: int, E: int, sm_count: int) -> int:
    """Tokens a block: 16, halved while the grid (ceil(S / tok) x B blocks)
    is under two blocks an SM or the block's shared memory passes 48 KB."""
    if min(B, S, E, sm_count) < 1:
        raise ValueError(f"plan_tokens({B}, {S}, {E}, {sm_count}): all must be >= 1")
    tok = MAX_TOK
    while tok > 1 and (B * -(-S // tok) < 2 * sm_count or smem_bytes(E, tok) > SMEM_LIMIT):
        tok //= 2
    if smem_bytes(E, tok) > SMEM_LIMIT:
        raise ValueError(f"{E} experts exceed the kernel's shared memory at one token a block")
    return tok


@functools.cache
def _lib():
    lib = build.load("moe_combine")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_combine_fwd.argtypes = [P, P, P, P, L, L, L, I, I, I, I, I, I, I, I, I, P]
    lib.moe_combine_fwd.restype = I
    return lib


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_inputs(ye, gsel, slot_of, out_dtype):
    """Raise on what the kernel does not take; returns (B, E, C, S, d)."""
    ts = (ye, gsel, slot_of)
    if not all(t.is_cuda for t in ts):
        raise ValueError("moe_combine kernel takes CUDA tensors only; kernels.ops routes "
                         "CPU tensors to the plain version")
    if len({t.device for t in ts}) != 1:
        raise ValueError("ye, gsel and slot_of must be on one device")
    if ye.dtype not in _DTYPE_CODES:
        raise ValueError(f"ye is {ye.dtype}: need one of "
                         f"{sorted(str(d) for d in _DTYPE_CODES)}")
    if gsel.dtype != torch.float32 or slot_of.dtype != torch.int32:
        raise ValueError(f"gsel {gsel.dtype}, slot_of {slot_of.dtype}: need float32 and int32")
    if out_dtype not in (torch.float32, ye.dtype):
        raise ValueError(f"out_dtype {out_dtype}: need float32 or ye's {ye.dtype}")
    if ye.dim() != 4 or gsel.dim() != 3 or slot_of.dim() != 3:
        raise ValueError(f"shapes ye {tuple(ye.shape)}, gsel {tuple(gsel.shape)}, slot_of "
                         f"{tuple(slot_of.shape)}: need [B,E,C,d], [B,E,C], [B,E,S]")
    B, E, C, d = ye.shape
    S = slot_of.shape[2]
    if tuple(gsel.shape) != (B, E, C) or tuple(slot_of.shape[:2]) != (B, E):
        raise ValueError(f"gsel {tuple(gsel.shape)} or slot_of {tuple(slot_of.shape)} do not "
                         f"match ye {tuple(ye.shape)}")
    if min(B, E, C, S, d) < 1 or B > 65535:
        raise ValueError(f"B {B}, E {E}, C {C}, S {S}, d {d}: need each >= 1 and B <= 65535")
    if ye.stride(3) != 1 or not gsel.is_contiguous() or not slot_of.is_contiguous():
        raise ValueError("moe_combine kernel needs ye's last axis contiguous and contiguous "
                         "gsel and slot_of")
    return B, E, C, S, d


def moe_combine(ye, gsel, slot_of, *, out_dtype=None):
    """ye [B, E, C, d] bf16/f32, gsel [B, E, C] f32, slot_of [B, E, S] int32
    (CUDA) -> y [B, S, d] in ``out_dtype`` (float32 or ye's dtype, the
    default). No gradient: ``combine`` is the differentiable entry."""
    global launches
    out_dtype = ye.dtype if out_dtype is None else out_dtype
    B, E, C, S, d = _check_inputs(ye, gsel, slot_of, out_dtype)
    v = 16 // ye.element_size()
    vec = (d % v == 0 and ye.data_ptr() % 16 == 0
           and all(ye.stride(i) % v == 0 for i in range(3)))
    tok = plan_tokens(B, S, E, sm_count(ye.device.index))
    y = torch.empty((B, S, d), dtype=out_dtype, device=ye.device)
    with torch.cuda.device(ye.device):
        stream = torch.cuda.current_stream(ye.device).cuda_stream
        err = _lib().moe_combine_fwd(
            ye.data_ptr(), gsel.data_ptr(), slot_of.data_ptr(), y.data_ptr(),
            ye.stride(0), ye.stride(1), ye.stride(2), B, E, C, S, d, tok,
            _DTYPE_CODES[ye.dtype], int(out_dtype == torch.float32), int(vec), stream)
    if err:
        raise RuntimeError(f"moe_combine kernel launch failed: CUDA error {err}")
    launches += 1
    return y


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ye, gsel, slot_of, out_dtype):
        ctx.save_for_backward(ye, gsel, slot_of)
        return moe_combine(ye, gsel, slot_of, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        ye, gsel, slot_of = ctx.saved_tensors
        dye, dgsel = ref.moe_combine_grad(dy, ye, gsel, slot_of)
        return (dye if ctx.needs_input_grad[0] else None,
                dgsel if ctx.needs_input_grad[1] else None, None, None)


def combine(ye, gsel, slot_of, *, out_dtype=None):
    """``moe_combine`` with a gradient for ye and gsel (plain PyTorch)."""
    return _Combine.apply(ye, gsel, slot_of, ye.dtype if out_dtype is None else out_dtype)
