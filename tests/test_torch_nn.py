"""Port layers vs the JAX reference on the CPU, with the JAX weights carried
across (``jax.tree.map(np.asarray, ...)`` then ``load_jax_params``) and
inputs made with numpy from a seed. f32 throughout; tolerance 1e-5 (the two
frameworks run the same f32 arithmetic and differ only in summation order
and in last-ulp transcendental results)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402

TOL = 1e-5
KEY = jax.random.PRNGKey(3)


def port(module, jparams):
    return load_jax_params(module, jax.tree.map(np.asarray, jparams))


def x_pair(shape, seed=0, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def err(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    jp = jnn.init_linear(KEY, 64, 96, bias=bias)
    if bias:
        jp["b"] = jnp.asarray(np.random.default_rng(1).standard_normal(96), jnp.float32)
    tp = port(tnn.Linear(64, 96, bias=bias), jp)
    jx, tx = x_pair((2, 5, 64))
    assert err(jnn.linear(jp, jx), tnn.linear(tp, tx)) < TOL


def test_embedding():
    jp = jnn.init_embedding(KEY, 50, 32)
    tp = port(tnn.Embedding(50, 32), jp)
    toks = np.random.default_rng(0).integers(0, 50, (3, 7)).astype(np.int32)
    assert err(jnn.embedding(jp, jnp.asarray(toks)),
               tnn.embedding(tp, torch.from_numpy(toks))) == 0.0


def test_rmsnorm():
    jp = {"g": jnp.asarray(np.random.default_rng(2).standard_normal(64), jnp.float32)}
    tp = port(tnn.RMSNorm(64), jp)
    jx, tx = x_pair((2, 5, 64), scale=3.0)
    assert err(jnn.rmsnorm(jp, jx), tnn.rmsnorm(tp, tx)) < TOL


def test_layernorm_uses_population_variance():
    rng = np.random.default_rng(3)
    jp = {"g": jnp.asarray(rng.standard_normal(64), jnp.float32),
          "b": jnp.asarray(rng.standard_normal(64), jnp.float32)}
    tp = port(tnn.LayerNorm(64), jp)
    jx, tx = x_pair((2, 5, 64), scale=3.0)
    assert err(jnn.layernorm(jp, jx), tnn.layernorm(tp, tx)) < TOL


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_half_split(theta):
    jx, tx = x_pair((2, 9, 4, 64))
    pos = np.stack([np.arange(9), np.arange(30, 39)]).astype(np.int32)
    want = jnn.apply_rope(jx, jnp.asarray(pos), jnn.rope_frequencies(64, theta=theta))
    got = tnn.apply_rope(tx, torch.from_numpy(pos), tnn.rope_frequencies(64, theta=theta))
    assert err(want, got) < TOL
    assert err(jnn.rope_frequencies(64, theta=theta), tnn.rope_frequencies(64, theta=theta)) < 1e-7


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind):
    jp = jnn.init_mlp(KEY, 64, 128, kind=kind)
    tp = port(tnn.MLP(64, 128, kind=kind), jp)
    jx, tx = x_pair((2, 5, 64), scale=2.0)
    assert err(jnn.mlp(jp, jx, kind=kind), tnn.mlp(tp, tx, kind=kind)) < TOL


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to approximate=True; torch's default is exact."""
    jx, tx = x_pair((1000,), scale=3.0)
    want = np.asarray(jax.nn.gelu(jx))
    exact = torch.nn.functional.gelu(tx).numpy()
    assert np.abs(want - exact).max() > 1e-4        # the trap is real
    jp = jnn.init_mlp(KEY, 8, 16, kind="gelu")
    tp = port(tnn.MLP(8, 16, kind="gelu"), jp)
    jx, tx = x_pair((4, 8), scale=4.0)
    assert err(jnn.mlp(jp, jx, kind="gelu"), tnn.mlp(tp, tx, kind="gelu")) < TOL


def attn_pair(H=4, KV=2, hd=32, d=64, bias=False):
    jp = jnn.init_attention(KEY, d, H, KV, hd, qkv_bias=bias)
    tp = port(tattn.Attention(d, H, KV, hd, qkv_bias=bias), jp)
    return jp, tp, dict(n_heads=H, n_kv=KV, head_dim=hd)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("window", [None, 8])
def test_attention_prefill(use_flash, window):
    jp, tp, kw = attn_pair(bias=True)
    jx, tx = x_pair((2, 32, 64))
    jo, (jk, jv) = jattn.attention_prefill(jp, jx, window=window, use_flash=use_flash, **kw)
    to, (tk, tv) = tattn.attention_prefill(tp, tx, window=window, use_flash=use_flash, **kw)
    assert err(jo, to) < TOL and err(jk, tk) < TOL and err(jv, tv) < TOL


def test_attention_prefill_blocked_path():
    jp, tp, kw = attn_pair()
    jx, tx = x_pair((1, 128, 64))
    jo, _ = jattn.attention_prefill(jp, jx, blocked_threshold=64, **kw)
    to, _ = tattn.attention_prefill(tp, tx, blocked_threshold=64, **kw)
    assert err(jo, to) < TOL


def test_sdpa_blocked_window():
    (jq, q), (jk, k) = x_pair((1, 128, 4, 32), 1), x_pair((1, 128, 2, 32), 2)
    jv, v = x_pair((1, 128, 2, 32), 3)
    want = jattn._sdpa_blocked(jq, jk, jv, window=40, kv_chunk=32)
    assert err(want, tattn._sdpa_blocked(q, k, v, window=40, kv_chunk=32)) < TOL


def decode_case(ring, pos, use_flash, C=8):
    jp, tp, kw = attn_pair()
    B = 3
    jk0, tk0 = x_pair((B, C, 2, 32), 5)
    jv0, tv0 = x_pair((B, C, 2, 32), 6)
    p = np.asarray(pos, dtype=np.int32)
    jcache = {"k": jk0, "v": jv0, "pos": jnp.asarray(p)}
    tcache = {"k": tk0.clone(), "v": tv0.clone(), "pos": torch.from_numpy(p)}
    jx, tx = x_pair((B, 1, 64), 7)
    jo, jc = jattn.attention_decode(jp, jx, jcache, ring=ring, use_flash=use_flash, **kw)
    to, tc = tattn.attention_decode(tp, tx, tcache, ring=ring, use_flash=use_flash, **kw)
    assert err(jo, to) < TOL
    assert err(jc["k"], tc["k"]) < TOL and err(jc["v"], tc["v"]) < TOL
    assert np.array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    assert tc["k"] is tcache["k"]            # written in place, same buffer returned


@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_decode_contiguous(use_flash):
    decode_case(False, [0, 3, 5], use_flash)


@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_decode_ring(use_flash):
    decode_case(True, [2, 9, 17], use_flash)


@pytest.mark.parametrize("use_flash", [False, True])
def test_attention_decode_full_cache_clamps_last_slot(use_flash):
    decode_case(False, [8, 12, 7], use_flash)


def test_make_kv_cache():
    c = tnn.make_kv_cache(2, 16, 4, 32)
    j = jnn.make_kv_cache(2, 16, 4, 32)
    for name in ("k", "v", "pos"):
        assert tuple(c[name].shape) == j[name].shape
    assert c["pos"].dtype == torch.int32 and c["k"] is not c["v"]
