"""Port kernels vs the JAX reference on the CPU.

The port's plain versions (``repro_torch.kernels.ref``) are held against the
reference oracles (``repro.kernels.ref``) at 1e-5 in f32: both compute the
same einsum/softmax in f32 and differ only in summation order. They are also
held against the Pallas kernels themselves (``repro.kernels.ops``, interpret
mode on the CPU) at the tolerances of ``tests/test_kernels.py``: 2e-3 in f32
(online vs one-pass softmax) and 4e-2 in bf16 (one bf16 rounding of the
output). Inputs are made with numpy from a seed and fed to both packages.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import moe_combine as tmc  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-3),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}
REF_TOL = 1e-5


def inputs(seed, shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def as_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def dec_mask(B, C, n_valid):
    nv = np.broadcast_to(np.asarray(n_valid), (B,))
    m = np.arange(C)[None, :] < nv[:, None]
    return jnp.asarray(m), torch.from_numpy(m)


def max_err(a, b):
    return float(np.abs(as_np(a) - as_np(b)).max())


@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (1, 128, 4, 2, 64, None), (2, 64, 6, 2, 128, None),
    (2, 128, 4, 1, 80, None), (1, 128, 4, 2, 64, 32), (1, 96, 8, 8, 64, 17)])
def test_flash_plain_matches_reference_oracle(B, S, H, Hkv, D, window):
    (jq, jk, jv), (q, k, v) = inputs(0, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)])
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    got = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert max_err(got, want) < REF_TOL


def test_flash_plain_noncausal_matches_reference_oracle():
    (jq, jk, jv), (q, k, v) = inputs(1, [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)])
    want = jref.flash_attention_ref(jq, jk, jv, causal=False)
    assert max_err(ref.flash_attention_ref(q, k, v, causal=False), want) < REF_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D", [(1, 128, 4, 2, 64), (2, 128, 4, 1, 80)])
def test_flash_ops_matches_pallas_interpret(B, S, H, Hkv, D, dtype):
    (jq, jk, jv), (q, k, v) = inputs(2, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    assert max_err(got, want) < DTYPES[dtype][2]


def test_flash_ops_window_matches_pallas_interpret():
    (jq, jk, jv), (q, k, v) = inputs(3, [(1, 256, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64)])
    want = jops.flash_attention(jq, jk, jv, causal=True, window=64)
    assert max_err(ops.flash_attention(q, k, v, causal=True, window=64), want) < 2e-3


@pytest.mark.parametrize("B,H,Hkv,D,C,nv", [
    (2, 8, 2, 64, 1024, 700), (1, 24, 8, 128, 256, 256), (4, 4, 4, 64, 512, 100),
    (2, 32, 8, 128, 128, 1), (3, 8, 4, 64, 512, [37, 512, 256]),
    (2, 8, 2, 64, 256, [0, 100])])
def test_decode_plain_matches_reference_oracle(B, H, Hkv, D, C, nv):
    (jq, jk, jv), (q, k, v) = inputs(4, [(B, 1, H, D), (B, C, Hkv, D), (B, C, Hkv, D)])
    jm, m = dec_mask(B, C, nv)
    want = jref.decode_attention_ref(jq, jk, jv, jm)
    got = ref.decode_attention_ref(q, k, v, m)
    assert got.shape == want.shape
    assert max_err(got, want) < REF_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,C,nv", [(2, 8, 2, 64, 1024, 700), (4, 4, 4, 64, 512, 100)])
def test_decode_ops_matches_pallas_interpret(B, H, Hkv, D, C, nv, dtype):
    (jq, jk, jv), (q, k, v) = inputs(5, [(B, 1, H, D), (B, C, Hkv, D), (B, C, Hkv, D)], dtype)
    jm, m = dec_mask(B, C, nv)
    want = jops.decode_attention(jq, jk, jv, jm)
    got = ops.decode_attention(q, k, v, m)
    assert got.dtype == DTYPES[dtype][1]
    assert max_err(got, want) < DTYPES[dtype][2]


def test_decode_ops_ragged_matches_pallas_interpret():
    B, H, Hkv, D, C = 3, 8, 4, 64, 512
    (jq, jk, jv), (q, k, v) = inputs(6, [(B, 1, H, D), (B, C, Hkv, D), (B, C, Hkv, D)])
    jm, m = dec_mask(B, C, [37, 512, 256])
    want = jops.decode_attention(jq, jk, jv, jm)
    assert max_err(ops.decode_attention(q, k, v, m), want) < 2e-3


def test_decode_no_valid_slot_is_mean_of_v():
    """A row with no valid slot: the reference's softmax over equal logits
    gives the mean of V, and so do the Pallas kernel and the port."""
    B, H, Hkv, D, C = 2, 8, 2, 64, 512
    (jq, jk, jv), (q, k, v) = inputs(7, [(B, 1, H, D), (B, C, Hkv, D), (B, C, Hkv, D)])
    jm, m = dec_mask(B, C, [0, 100])
    got = ops.decode_attention(q, k, v, m)
    mean_v = v[0].mean(dim=0).repeat_interleave(H // Hkv, dim=0)     # [H, D]
    assert float((got[0, 0] - mean_v).abs().max()) < REF_TOL
    assert max_err(got, jops.decode_attention(jq, jk, jv, jm)) < 2e-3


def test_cpu_tensors_take_plain_version_without_launch():
    (_, _, _), (q, k, v) = inputs(8, [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)])
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v))
    m = torch.ones(1, 64, dtype=torch.bool)
    out = ops.decode_attention(q[:, :1], k, v, m)
    assert torch.equal(out, ref.decode_attention_ref(q[:, :1], k, v, m))
    assert ops.launch_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k = torch.zeros(1, 64, 4, 64), torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tda.decode_attention(q[:, :1], k, k, torch.ones(1, 64, dtype=torch.bool))


def test_ops_rejects_devices_other_than_cuda_and_cpu():
    q = torch.zeros(1, 64, 4, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q, q)


def test_reset_launch_counts():
    tfa.launches, tda.launches, tmc.launches = 3, 5, 7
    assert ops.launch_counts() == {"flash_attention": 3, "decode_attention": 5,
                                   "moe_combine": 7}
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "moe_combine": 0}


def test_build_targets_sm90a_and_keys_by_source(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    out = build.library_path("decode_attention")
    cmd = build.nvcc_command("decode_attention", out)
    assert cmd[0] == str(nvcc)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith("csrc/decode_attention.cu")
    assert out.parent == build.BUILD_DIR and out.parent.parts[-2:] == ("build", "kernels")
    assert out != build.library_path("flash_attention")
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


# --- the split-C decode kernel's plan and algorithm, on the CPU ------------

SM_COUNT = 132      # an H100's SMs; the planner's other input


@pytest.mark.parametrize("B,Hkv,C,sm,rg", [
    (4, 8, 1024, 132, 1), (4, 2, 1024, 132, 3), (4, 8, 1000, 132, 1), (1, 1, 1, 132, 1),
    (2, 2, 31, 132, 2), (64, 8, 1024, 132, 1), (1, 8, 32768, 132, 2),
    (1, 1, 1 << 17, 132, 4), (3, 4, 777, 16, 1)])
def test_plan_splits_covers_cache_once(B, Hkv, C, sm, rg):
    n, chunk = tda.plan_splits(B, Hkv, C, sm, rg)
    starts = [i * chunk for i in range(n)]
    ends = [min(C, s + chunk) for s in starts]
    assert all(e > s for s, e in zip(starts, ends, strict=True))     # no empty split
    assert starts[0] == 0 and ends[-1] == C
    assert all(e == s for e, s in zip(ends[:-1], starts[1:], strict=True))
    assert 1 <= n <= tda.MAX_SPLITS and chunk <= tda.MAX_CHUNK
    assert n == 1 or chunk % tda.TILE == 0
    # as many CTAs as the aim asks, unless the cluster or the tiles run out
    assert (B * Hkv * rg * n >= tda.CTAS_PER_SM * sm or n == tda.MAX_SPLITS
            or chunk == tda.TILE or n == _cdiv(C, chunk))


def _cdiv(a, b):
    return -(-a // b)


def test_plan_splits_main_path_shapes():
    """llama3.2-1b (B4 Hkv8, g 4: one CTA per kv head) and starcoder2-3b (B4
    Hkv2, g 12: three) at C=1024 on 132 SMs: the cluster's 8 splits, chunks
    of whole tiles; a large batch needs no split."""
    assert [tda.row_groups(H, Hkv) for H, Hkv in ((32, 8), (24, 2), (8, 8), (40, 8))] == [
        1, 3, 1, 2]
    assert tda.plan_splits(4, 8, 1024, SM_COUNT) == (8, 128)
    assert tda.plan_splits(4, 2, 1024, SM_COUNT, tda.row_groups(24, 2)) == (8, 128)
    assert tda.plan_splits(64, 8, 1024, SM_COUNT) == (1, 1024)
    with pytest.raises(ValueError):
        tda.plan_splits(1, 1, tda.MAX_SPLITS * tda.MAX_CHUNK + 1, SM_COUNT)


def split_decode_model(q, k, v, mask, n_splits, chunk, tile=tda.TILE):
    """The CUDA kernel's algorithm in plain f32 torch: per split, the online
    softmax over its tiles, skipping a tile whose mask is all false when the
    row has a valid slot; each split's partial (m, l, acc), m = -inf for a
    split without a kept tile; then the merge."""
    B, _, H, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, D).float() * (1.0 / D ** 0.5)
    kf, vf = k.float(), v.float()
    out = torch.zeros(B, Hkv, g, D)
    neg = torch.finfo(torch.float32).min
    for b in range(B):
        row_any = bool(mask[b].any())
        for h in range(Hkv):
            ms, ls, accs = [], [], []
            for s in range(n_splits):
                m = torch.full((g,), -torch.inf)
                l, acc = torch.zeros(g), torch.zeros(g, D)
                for t0 in range(s * chunk, min(C, (s + 1) * chunk), tile):
                    t1 = min(C, (s + 1) * chunk, t0 + tile)
                    keep = mask[b, t0:t1]
                    if row_any and not bool(keep.any()):
                        continue
                    x = torch.where(keep, qg[b, h] @ kf[b, t0:t1, h].T, neg)
                    m_new = torch.maximum(m, x.max(-1).values)
                    p = torch.exp(x - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = alpha * l + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vf[b, t0:t1, h]
                    m = m_new
                ms.append(m), ls.append(l), accs.append(acc)
            m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
            w = torch.where(m == -torch.inf, 0.0, torch.exp(m - m.max(0).values))
            den = (w * l).sum(0)
            den = torch.where(den == 0, 1.0, den)
            out[b, h] = (w[:, :, None] * acc).sum(0) / den[:, None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def plan_masks(B, C, n_splits, chunk, rng):
    """Masks that exercise the kernel's split and tile skipping, by name."""
    last = (n_splits - 1) * chunk
    whole = np.zeros((B, C), bool)               # row 0: split 1 all false
    whole[0, :chunk] = True
    whole[0, 2 * chunk:] = True
    whole[1:, : C // 2] = True
    holes = rng.random((B, C)) < 0.3              # non-prefix, with holes
    holes[:, 5 * tda.TILE: 9 * tda.TILE] = False  # whole tiles masked
    none = np.zeros((B, C), bool)                 # row 0 has no valid slot
    none[1:, :100] = True
    tail = np.zeros((B, C), bool)                 # valid slots in the last split only
    tail[:, last + 3:] = True
    single = np.zeros((B, C), bool)               # one valid slot per row
    single[np.arange(B), rng.integers(0, C, B)] = True
    return {"whole_split_false": whole, "holes": holes, "no_valid_slot": none,
            "last_split_only": tail, "single_slot": single}


MASK_NAMES = ["whole_split_false", "holes", "no_valid_slot", "last_split_only",
              "single_slot"]


@pytest.mark.parametrize("name", MASK_NAMES)
def test_split_decode_model_matches_pallas_interpret(name):
    B, H, Hkv, D, C = 2, 8, 2, 64, 512
    n, chunk = tda.plan_splits(B, Hkv, C, SM_COUNT)
    assert n > 2
    (jq, jk, jv), (q, k, v) = inputs(9, [(B, 1, H, D), (B, C, Hkv, D), (B, C, Hkv, D)])
    m = plan_masks(B, C, n, chunk, np.random.default_rng(10))[name]
    got = split_decode_model(q, k, v, torch.from_numpy(m), n, chunk)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(m))
    assert max_err(got, want) < 2e-3
    if name == "no_valid_slot":
        mean_v = v[0].mean(dim=0).repeat_interleave(H // Hkv, dim=0)
        assert float((got[0, 0] - mean_v).abs().max()) < REF_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_model_ragged_cache_matches_reference_oracle(dtype):
    """C = 1000 is no multiple of the chunk (nor of the Pallas kernel's
    512-slot block): held against the reference oracle."""
    B, H, Hkv, D, C = 2, 8, 2, 64, 1000
    n, chunk = tda.plan_splits(B, Hkv, C, SM_COUNT)
    assert C % chunk
    (jq, jk, jv), (q, k, v) = inputs(11, [(B, 1, H, D), (B, C, Hkv, D), (B, C, Hkv, D)],
                                     dtype)
    m = plan_masks(B, C, n, chunk, np.random.default_rng(12))["holes"]
    got = split_decode_model(q, k, v, torch.from_numpy(m), n, chunk)
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(m))
    assert max_err(got, want) < DTYPES[dtype][2]


# --- the packed-tile flash kernel's plan and algorithm, on the CPU ----------

# chip_smoke.py's FA_SHAPES: the reference test shapes (B, S, H, Hkv, D)
FA_SHAPES = [(1, 128, 4, 2, 64), (2, 256, 8, 8, 64), (1, 256, 6, 2, 128), (2, 128, 4, 1, 80)]
# the main path's shapes: llama3.2-1b and starcoder2-3b at the serving length
# and at a prefill length, and group sizes off the power-of-two grid
PLAN_SHAPES = [(4, 32, 32, 8, 64), (4, 32, 24, 2, 128), (1, 2048, 32, 8, 64),
               (1, 2048, 24, 2, 128), (2, 33, 6, 2, 128), (1, 100, 16, 1, 64),
               (3, 1, 4, 4, 80), (1, 65, 8, 8, 64)]


def packed_rows(plan, S, g):
    """(tile, warpgroup, row) -> (position, head in the group) for every row
    the kernel stores: rows past P*g and positions past S are not stored."""
    P, nwg, n_tiles = plan[:3]
    for t in range(n_tiles):
        for w in range(nwg):
            for r in range(P * g):
                pos = t * nwg * P + w * P + r // g
                if pos < S:
                    yield t, w, r, pos, r % g


@pytest.mark.parametrize("B,S,H,Hkv,D", PLAN_SHAPES)
def test_plan_tiles_covers_every_row_once(B, S, H, Hkv, D):
    plan = tfa.plan_tiles(B, S, H, Hkv, D, sm_count=SM_COUNT)
    g = H // Hkv
    P, nwg, n_tiles, block_k, grid = plan
    assert P * g <= tfa.ROWS and nwg in (1, 2) and grid == (B * Hkv, n_tiles, 1)
    assert block_k == (tfa.BK_F32_SHORT if S <= tfa.BK_F32_SHORT else tfa.BK)
    assert (n_tiles - 1) * nwg * P < S <= n_tiles * nwg * P      # no empty CTA
    seen = {}
    for _, _, _, pos, head in packed_rows(plan, S, g):
        seen[pos, head] = seen.get((pos, head), 0) + 1
    assert seen == {(s, h): 1 for s in range(S) for h in range(g)}


@pytest.mark.parametrize("B,S,H,Hkv,D", PLAN_SHAPES[:4] + [(1, 300, 12, 1, 64)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None),
                                           (False, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_plan_tiles_kv_range_holds_every_unmasked_pair(B, S, H, Hkv, D, causal, window, bf16):
    plan = tfa.plan_tiles(B, S, H, Hkv, D, bf16=bf16, sm_count=SM_COUNT)
    P, nwg, bk = plan.positions, plan.warpgroups, plan.block_k
    cols = np.arange(S)
    for t in range(plan.n_tiles):
        q0 = t * nwg * P
        pos = np.arange(q0, min(q0 + nwg * P, S))
        keep = np.ones((len(pos), S), bool)
        if causal:
            keep &= cols[None, :] <= pos[:, None]
        if window:
            keep &= cols[None, :] > pos[:, None] - window
        tiles = kv_tiles(int(pos[0]), int(pos[-1]), S, causal, window, bk)
        assert set(np.unique(cols[keep.any(0)] // bk)) <= set(tiles)
        assert tiles.start >= 0 and tiles.stop <= _cdiv(S, bk) and len(tiles) >= 1


def test_plan_tiles_main_path_shapes():
    """llama3.2-1b (g 4: 16 positions) and starcoder2-3b (g 12: 5) at the
    serving length take one consumer warpgroup (64 and 56 CTAs on 132 SMs);
    at 2048 tokens two (512 and 410 CTAs); f32 takes 32-row K/V tiles at
    the serving length, bf16 128-row ones at 2048; g = 3 packs 21
    positions."""
    plans = [tfa.plan_tiles(*shape, sm_count=SM_COUNT) for shape in PLAN_SHAPES[:4]]
    assert plans == [(16, 1, 2, 32, (32, 2, 1)), (5, 1, 7, 32, (8, 7, 1)),
                     (16, 2, 64, 64, (8, 64, 1)), (5, 2, 205, 64, (2, 205, 1))]
    assert [p.grid[0] * p.grid[1] for p in plans] == [64, 56, 512, 410]
    assert [tfa.plan_tiles(*shape, bf16=True, sm_count=SM_COUNT).block_k
            for shape in PLAN_SHAPES[:4]] == [64, 64, 128, 128]
    assert tfa.plan_tiles(1, 100, 6, 2, 128, sm_count=SM_COUNT).positions == 21
    assert tfa.plan_tiles(1, 64, 16, 1, 64, warpgroups=2).n_tiles == 8


@pytest.mark.parametrize("args", [(1, 32, 4, 2, 60), (1, 32, 4, 2, 136), (1, 32, 34, 2, 64),
                                  (1, 32, 6, 4, 64), (0, 32, 4, 2, 64)])
def test_plan_tiles_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        tfa.plan_tiles(*args)


def kv_tiles(q_first, q_last, S, causal, window, bk):
    """The kernel's kv range: the K/V tiles (bk rows each) from the
    window's first tile to the causal diagonal of the CTA's last position;
    every other tile is masked for all of its positions."""
    lo = max(0, q_first - window + 1) // bk if window else 0
    hi = q_last // bk + 1 if causal else _cdiv(S, bk)
    return range(lo, hi)


def tf32_round(x):
    """Round to nearest (ties away from zero) to TF32's 10 mantissa bits:
    the low 13 bits of the f32 pattern cleared after adding half of them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """What the tensor core reads of an f32 pattern given as TF32."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a, b):
    """The kernel's f32 product: hi = tf32(x) rounded, lo = x - hi (exact)
    read as TF32 by truncation, a.b as hi.lo + lo.hi + hi.hi; each TF32
    product is exact in f32, sums in f32."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return ah @ bl + al @ bh + ah @ bh


def matmul_tf32(a, b):
    return tf32_round(a) @ tf32_round(b)


def packed_flash_model(q, k, v, *, causal=True, window=None, plan=None, matmul=torch.matmul):
    """The CUDA kernel's algorithm in plain f32 torch: per packed tile and
    warpgroup, rows position-major (position q0w + r // g, head r % g); the
    kv tiles of ``kv_tiles(first, last position of the CTA)`` at the
    kernel's tile size for the dtype; a tile-by-tile online softmax with
    finfo.min for masked columns and -inf past S; the scale on the f32
    product; a zero denominator becomes 1."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    plan = plan or tfa.plan_tiles(B, S, H, Hkv, D, bf16=q.dtype == torch.bfloat16)
    P, nwg, BKT = plan.positions, plan.warpgroups, plan.block_k
    neg = torch.finfo(torch.float32).min
    qh = q.float().reshape(B, S, Hkv, g, D).permute(0, 2, 1, 3, 4)      # [B,Hkv,S,g,D]
    pad = _cdiv(S, BKT) * BKT - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)
    out = torch.zeros(B, S, H, D)
    oh = out.view(B, S, Hkv, g, D).permute(0, 2, 1, 3, 4)
    for t in range(plan.n_tiles):
        q0 = t * nwg * P
        tiles = kv_tiles(q0, min(q0 + nwg * P, S) - 1, S, causal, window, BKT)
        for w in range(nwg):
            r = torch.arange(P * g)
            pos, head = q0 + w * P + r // g, r % g
            rows = qh[:, :, pos.clamp(max=S - 1), head]                  # [B,Hkv,R,D]
            m = torch.full(rows.shape[:3], neg)
            l = torch.zeros(rows.shape[:3])
            acc = torch.zeros(rows.shape)
            for kt in tiles:
                cols = torch.arange(kt * BKT, (kt + 1) * BKT)
                x = matmul(rows, kf[:, :, kt * BKT:(kt + 1) * BKT].transpose(-1, -2)) / D ** 0.5
                masked = torch.zeros(len(r), BKT, dtype=torch.bool)
                if causal:
                    masked |= cols[None, :] > pos[:, None]
                if window:
                    masked |= cols[None, :] <= pos[:, None] - window
                x = x.masked_fill(masked, neg).masked_fill(cols >= S, -torch.inf)
                m_new = torch.maximum(m, x.max(-1).values)
                p = torch.exp(x - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(-1)
                acc = acc * alpha[..., None] + matmul(p, vf[:, :, kt * BKT:(kt + 1) * BKT])
                m = m_new
            o = acc / torch.where(l == 0, 1.0, l)[..., None]
            keep = pos < S
            oh[:, :, pos[keep], head[keep]] = o[:, :, keep]
    return out.to(q.dtype)


def fa_inputs(seed, B, S, H, Hkv, D, dtype="float32"):
    return inputs(seed, [(B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D", FA_SHAPES)
def test_packed_flash_model_matches_pallas_interpret(B, S, H, Hkv, D, dtype):
    (jq, jk, jv), (q, k, v) = fa_inputs(13, B, S, H, Hkv, D, dtype)
    got = packed_flash_model(q, k, v)
    want = jops.flash_attention(jq, jk, jv, causal=True)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    assert max_err(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 32), (True, 64), (True, 128), (False, None)])
def test_packed_flash_model_masks_match_pallas_interpret(causal, window, dtype):
    """Windows whose edge cuts through the 64-row kv tiles and the packed
    tiles, and the non-causal case (every kv tile of the sequence)."""
    (jq, jk, jv), (q, k, v) = fa_inputs(14, 1, 256, 4, 2, 64, dtype)
    got = packed_flash_model(q, k, v, causal=causal, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    assert max_err(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window", [
    (2, 33, 32, 8, 64, None), (1, 101, 24, 2, 128, None), (1, 100, 8, 2, 80, 40),
    (1, 77, 6, 2, 128, None)])
def test_packed_flash_model_ragged_matches_reference_oracle(B, S, H, Hkv, D, window, dtype):
    """S no multiple of P (16, 5, 16, 21 positions) nor of the kv tile: the
    Pallas kernel does not take these, so the oracle holds the model."""
    plan = tfa.plan_tiles(B, S, H, Hkv, D, bf16=dtype == "bfloat16")
    assert S % plan.positions and S % plan.block_k
    (jq, jk, jv), (q, k, v) = fa_inputs(15, B, S, H, Hkv, D, dtype)
    got = packed_flash_model(q, k, v, window=window, plan=plan)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    assert max_err(got, want) < DTYPES[dtype][2]


@pytest.mark.parametrize("B,S,H,Hkv,D", PLAN_SHAPES[:2])
def test_3xtf32_products_hold_f32_accuracy(B, S, H, Hkv, D):
    """The f32 kernel's split products stay within 1e-5 of f32 at the slice
    shapes, against the f64 oracle; one TF32 pass does not, which is why the
    kernel never takes it."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    exact = ref.flash_attention_ref(q.double(), k.double(), v.double()).float()
    f32 = packed_flash_model(q, k, v)
    split3 = packed_flash_model(q, k, v, matmul=matmul_3xtf32)
    single = packed_flash_model(q, k, v, matmul=matmul_tf32)
    assert max_err(f32, exact) < 1e-5
    assert max_err(split3, exact) < 1e-5
    assert max_err(split3, f32) < 1e-5
    assert max_err(single, exact) > 1e-4
