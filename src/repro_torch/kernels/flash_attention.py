"""Flash attention (prefill) — the hand-written Hopper CUDA kernel.

Port of ``repro/kernels/flash_attention.py`` (Pallas TPU). The kernel source
is ``csrc/flash_attention.cu``; its header says what bounds it on the H100
and how the design answers. This wrapper takes CUDA tensors only: it checks
them, plans the tiles, allocates the output, launches on the current stream
without synchronising and counts the launch in ``launches``. The plain
version is ``kernels.ref.flash_attention_ref``; ``kernels.ops`` picks between
the two by tensor device.

The kernel packs the GQA group into the rows of a tile: a consumer
warpgroup's 64 rows are ``P = 64 // g`` positions times the ``g`` query heads
of one kv head, position-major, so one K/V tile serves all ``g`` heads.
``plan_tiles`` picks ``P``, one or two consumer warpgroups per CTA, the kv
rows per K/V tile and the grid (B * Hkv, n_tiles).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import refuse_grad, sm_count

launches = 0            # incremented once per successful kernel launch

ROWS = 64               # rows of a packed tile: one warpgroup's wgmma M
BK = 64                 # kv rows per K/V tile
BK_BF16_LONG = 128      # in bf16 once S > BK
BK_F32_SHORT = 32       # in f32 while S <= 32
MAX_GROUP = 16          # query heads per kv head
MAX_HEAD_DIM = 128
MAX_TILES = 65535       # grid.y
H100_SMS = 132

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TilePlan(NamedTuple):
    positions: int      # P: positions per consumer warpgroup
    warpgroups: int     # consumer warpgroups per CTA (1 or 2)
    n_tiles: int        # packed tiles (CTAs) per (b, kv head)
    block_k: int        # kv rows per K/V tile
    grid: tuple[int, int, int]


def plan_tiles(B: int, S: int, H: int, Hkv: int, D: int, *, bf16: bool = False,
               sm_count: int = H100_SMS, warpgroups: int | None = None) -> TilePlan:
    """Plan the packed tiles of one call.

    A CTA covers ``warpgroups * P`` consecutive positions of one (b, kv
    head); its warpgroup ``w`` owns positions ``q0 + w*P .. q0 + w*P + P-1``
    and row ``r < P*g`` of that warpgroup is (position ``q0 + w*P + r // g``,
    head ``hk*g + r % g``). Two warpgroups share each K/V tile between 128
    rows; they are used when that still gives at least one CTA per SM, so
    that the short serving prompts keep the card's SMs busy with one. bf16
    takes 128-row K/V tiles once the sequence is longer than one 64-row
    tile (wider wgmma, half the handshakes per column); f32 takes 64, or 32
    while the sequence fits in 32 (no products over zero-filled rows)."""
    if min(B, S, H, Hkv, D, sm_count) < 1 or H % Hkv:
        raise ValueError(f"plan_tiles({B}, {S}, {H}, {Hkv}, {D}): need positive sizes "
                         "and H divisible by Hkv")
    g = H // Hkv
    if g > MAX_GROUP:
        raise ValueError(f"group of {g} query heads per kv head exceeds {MAX_GROUP}")
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D}: the kernel takes multiples of 8 up to "
                         f"{MAX_HEAD_DIM} (TMA rows of 16-byte multiples)")
    P = ROWS // g
    if warpgroups is None:
        warpgroups = 2 if B * Hkv * _cdiv(S, 2 * P) >= sm_count else 1
    if warpgroups not in (1, 2):
        raise ValueError(f"warpgroups must be 1 or 2, got {warpgroups}")
    n_tiles = _cdiv(S, warpgroups * P)
    if n_tiles > MAX_TILES:
        raise ValueError(f"sequence of {S} needs {n_tiles} tiles, over {MAX_TILES}")
    if bf16:
        block_k = BK_BF16_LONG if S > BK else BK
    else:
        block_k = BK_F32_SHORT if S <= BK_F32_SHORT else BK
    return TilePlan(P, warpgroups, n_tiles, block_k, (B * Hkv, n_tiles, 1))


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P]
    lib.flash_attention_fwd.restype = I
    return lib


def _check_inputs(q, k, v):
    """Raise on what the kernel does not take (``plan_tiles`` checks the
    head_dim and group size); returns (B, S, H, Hkv, D)."""
    refuse_grad("flash_attention", q, k, v)
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned q, k and v (TMA)")
    return B, S, H, Hkv, D


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    warpgroups: int | None = None):
    """q [B, S, H, D]; k, v [B, S, Hkv, D] (CUDA) -> [B, S, H, D].

    ``warpgroups`` overrides the planner's choice (for measuring both)."""
    global launches
    B, S, H, Hkv, D = _check_inputs(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    plan = plan_tiles(B, S, H, Hkv, D, bf16=q.dtype == torch.bfloat16,
                      sm_count=sm_count(q.device.index), warpgroups=warpgroups)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, Hkv, D, int(causal), window or 0, _DTYPE_CODES[q.dtype],
            plan.positions, plan.warpgroups, plan.n_tiles, plan.block_k, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
