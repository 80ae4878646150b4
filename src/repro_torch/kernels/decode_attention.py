"""GQA single-token decode attention — the hand-written Hopper CUDA kernel.

Port of ``repro/kernels/decode_attention.py`` (Pallas TPU). The kernel
source is ``csrc/decode_attention.cu``; its header says what bounds it on
the H100 and how the design answers. This wrapper takes CUDA tensors only:
it checks them, allocates the output, launches on the current stream without
synchronising and counts the launch in ``launches``. The plain version is
``kernels.ref.decode_attention_ref``; ``kernels.ops`` picks between the two
by tensor device.

The kernel splits the cache across CTAs (flash-decoding). A CTA serves up
to 4 query heads of one kv head (``row_groups`` CTAs per kv head), and
``plan_splits`` cuts the C slots into ``n_splits <= 8`` chunks, aiming at
two CTAs per SM: the grid is (B * Hkv * row_groups, n_splits), one
thread-block cluster of n_splits CTAs per (b, kv head, row group). Each CTA
keeps its partial softmax state (m, l, acc) in f32 in its own shared
memory, and the cluster merges the partials through distributed shared
memory in the same launch: no scratch tensor and no counters in device
memory. With ``return_lse`` the kernel also writes each (b, head)'s
log-sum-exp of the scaled logits over the valid slots (f32 [B, H]), and a
row with no valid slot gives out = 0 and lse = -inf: the sharded decode
merges the ranks' slices of one cache with it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0            # incremented once per successful kernel launch

MAX_GROUP = 16          # query heads per kv head
HEAD_DIMS = (64, 80, 128)   # the kernel's template instances
TILE = 32               # slots per K/V tile, one per lane of a warp
ROWS_PER_CTA = 4        # query heads per CTA, one per warp
CTAS_PER_SM = 2         # what plan_splits aims at, within MAX_SPLITS
MAX_SPLITS = 8          # CTAs in one cluster (the portable limit)
MAX_CHUNK = 16384       # slots per split

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_splits(B: int, Hkv: int, C: int, sm_count: int,
                row_groups: int = 1) -> tuple[int, int]:
    """Split C slots into chunks for B * Hkv (b, kv head) pairs, each served
    by ``row_groups`` CTAs of up to 4 query heads, on a card with
    ``sm_count`` SMs -> (n_splits, chunk).

    Aims at ``CTAS_PER_SM`` CTAs per SM with at most ``MAX_SPLITS`` splits:
    the chunk is a whole number of tiles. Chunk i covers
    [i * chunk, min(C, (i + 1) * chunk)); every chunk is non-empty and the
    last may be short."""
    if min(B, Hkv, C, sm_count, row_groups) < 1:
        raise ValueError(f"plan_splits({B}, {Hkv}, {C}, {sm_count}, {row_groups}): "
                         "all must be >= 1")
    want = min(_cdiv(CTAS_PER_SM * sm_count, B * Hkv * row_groups), MAX_SPLITS)
    chunk = _cdiv(_cdiv(C, want), TILE) * TILE
    if chunk > MAX_CHUNK:
        raise ValueError(f"cache of {C} slots exceeds {MAX_SPLITS} x {MAX_CHUNK}")
    n_splits = _cdiv(C, chunk)
    return n_splits, (C if n_splits == 1 else chunk)


def row_groups(H: int, Hkv: int) -> int:
    """CTAs per (b, kv head): one warp per query head, 4 warps per CTA."""
    return _cdiv(H // Hkv, ROWS_PER_CTA)


@functools.cache
def _lib():
    lib = build.load("decode_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_fwd.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, P]
    lib.decode_attention_fwd.restype = I
    return lib


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_grad(kernel: str, *ts) -> None:
    """The kernels have no backward (the Pallas kernels have none either):
    raise, rather than return an output autograd cannot see, when grad is
    enabled and an input requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError(f"{kernel} kernel has no backward: an input requires grad; "
                         "train through attention_prefill(sdpa=True), the reference's "
                         "use_flash=False path")


def _check_inputs(q, k, v, valid_mask):
    """Raise on what the kernel does not take; returns (B, C, H, Hkv, D)."""
    ts = (q, k, v, valid_mask)
    refuse_grad("decode_attention", q, k, v)
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
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of the kernel's {HEAD_DIMS}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"group of {H // Hkv} query heads per kv head exceeds {MAX_GROUP}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("decode_attention kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention kernel needs 16-byte aligned q, k and v")
    return B, C, H, Hkv, D


def decode_attention(q, k, v, valid_mask, *, return_lse: bool = False):
    """q [B, 1, H, D]; k, v [B, C, Hkv, D]; valid_mask [B, C] bool (CUDA)
    -> out [B, 1, H, D], or (out, lse [B, H] f32) with ``return_lse``."""
    global launches
    B, C, H, Hkv, D = _check_inputs(q, k, v, valid_mask)
    n_splits, chunk = plan_splits(B, Hkv, C, sm_count(q.device.index), row_groups(H, Hkv))
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse
           else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, C, H, Hkv, D,
            _DTYPE_CODES[q.dtype], n_splits, chunk, stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out
