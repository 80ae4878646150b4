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
    tfa.launches, tda.launches = 3, 5
    assert ops.launch_counts() == {"flash_attention": 3, "decode_attention": 5}
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0}


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
