"""Port's Mamba2 block and hybrid family (zamba2-2.7b: a Mamba2 backbone
with one shared attention block) vs the JAX reference on the CPU, at smoke
size with the reference's weights carried across through
``models/convert.py``; and the executor's handling of zamba's weights and
state (``quantize_params`` grouping, ``step_bytes``).

Tolerances: the Mamba2 scan, its state and chained decode within 1e-5
(one block, f32); forward and chained decode logits within 1e-4 on the
plain path and 5e-3 with the kernels' plain versions against the Pallas
kernels in interpret mode; quantised serve steps within 4e-2 of max-abs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_families import carry  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.cluster import executor as jexecutor  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import api as jmodels  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models.config import InputShape as JShape  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.cluster import executor  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import api as models  # noqa: E402
from repro_torch.models import steps, zamba  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.convert import cache_from_numpy  # noqa: E402

NAME = "zamba2-2.7b"
PLAIN_TOL, BLOCK_TOL, KERNEL_TOL, QUANT_TOL = 1e-4, 1e-5, 5e-3, 4e-2
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def err(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float32) - b.detach().float().numpy()).max())


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def pair(use_flash=False):
    jcfg = JARCHS[NAME].smoke().replace(use_flash=use_flash)
    tcfg = ARCHS[NAME].smoke().replace(use_flash=use_flash)
    jp = jmodels.init_model(KEY, jcfg)
    return jcfg, tcfg, jp, carry(models.init_model(1, tcfg, device="cpu"), jp)


def batches(vocab, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


# ---------------------------------------------------------------- Mamba2 --

DIM, HEADS, STATE = 32, 4, 8


def mamba_pair(seed=3):
    jp = jnn.init_mamba2(jax.random.PRNGKey(seed), DIM, n_heads=HEADS, d_state=STATE)
    tp = carry(tnn.Mamba2(DIM, n_heads=HEADS, d_state=STATE), jp)
    return jp, tp


def test_mamba2_parameters_match_reference():
    jp, tp = mamba_pair()
    assert {n for n, _ in tp.named_parameters()} == {
        ".".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for name in ("a_log", "dt_bias", "d_skip"):
        assert getattr(tp, name).dtype == torch.float32
    bf = tnn.Mamba2(DIM, n_heads=HEADS, d_state=STATE, dtype=torch.bfloat16)
    assert bf.a_log.dtype == torch.float32 and bf.conv_w.dtype == torch.bfloat16
    assert torch.equal(bf.a_log, torch.log(torch.linspace(1.0, 16.0, HEADS)))


@pytest.mark.parametrize("chunk", [8, 32])
def test_mamba2_scan_matches_reference(chunk):
    """S = 32: four chunks of 8 carry the [B, H, P, N] state across chunk
    edges; one chunk of 32 has only the intra-chunk quadratic form."""
    jp, tp = mamba_pair()
    x = rand((2, 32, DIM), 4)
    jy, jst = jnn.mamba2_scan(jp, jnp.asarray(x), n_heads=HEADS, d_state=STATE, chunk=chunk,
                              return_state=True)
    with torch.no_grad():
        ty, tst = tnn.mamba2_scan(tp, torch.from_numpy(x), n_heads=HEADS, d_state=STATE,
                                  chunk=chunk, return_state=True)
    assert ty.shape == x.shape and err(jy, ty) < BLOCK_TOL
    assert tst["ssm"].dtype == torch.float32 and tst["ssm"].shape == (2, HEADS, 16, STATE)
    for k in ("ssm", "conv"):
        assert err(jst[k], tst[k]) < BLOCK_TOL, k


def test_mamba2_scan_chunkings_agree():
    _, tp = mamba_pair(5)
    x = torch.from_numpy(rand((1, 32, DIM), 6))
    with torch.no_grad():
        a = tnn.mamba2_scan(tp, x, n_heads=HEADS, d_state=STATE, chunk=8)
        b = tnn.mamba2_scan(tp, x, n_heads=HEADS, d_state=STATE, chunk=32)
    assert torch.allclose(a, b, atol=BLOCK_TOL)


def test_mamba2_scan_refuses_ragged_sequence():
    _, tp = mamba_pair()
    with pytest.raises(ValueError, match="divisible by chunk 8"):
        tnn.mamba2_scan(tp, torch.zeros(1, 20, DIM), n_heads=HEADS, d_state=STATE, chunk=8)


def test_mamba2_decode_chained_matches_scan_and_reference():
    """Decoding S tokens one by one from ``make_mamba_state`` gives the
    scan's outputs and its final state, in the port and the reference."""
    jp, tp = mamba_pair(7)
    S = 9
    x = rand((2, S, DIM), 8)
    jscan, jfin = jnn.mamba2_scan(jp, jnp.asarray(x), n_heads=HEADS, d_state=STATE,
                                  return_state=True)
    jst = jnn.make_mamba_state(2, DIM, n_heads=HEADS, d_state=STATE)
    tst = tnn.make_mamba_state(2, DIM, n_heads=HEADS, d_state=STATE)
    for t in range(S):
        jy, jst = jnn.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, n_heads=HEADS,
                                    d_state=STATE)
        given = {k: v.clone() for k, v in tst.items()}
        with torch.no_grad():
            ty, new = tnn.mamba2_decode(tp, torch.from_numpy(x[:, t:t + 1]), tst,
                                        n_heads=HEADS, d_state=STATE)
        assert all(torch.equal(given[k], tst[k]) for k in tst)   # left untouched
        tst = new
        assert err(jy, ty) < BLOCK_TOL and err(jscan[:, t:t + 1], ty) < BLOCK_TOL, t
    for k in ("ssm", "conv"):
        assert err(jst[k], tst[k]) < BLOCK_TOL and err(jfin[k], tst[k]) < BLOCK_TOL, k


def test_mamba2_decode_refuses_more_than_one_token():
    _, tp = mamba_pair()
    st = tnn.make_mamba_state(1, DIM, n_heads=HEADS, d_state=STATE)
    with pytest.raises(ValueError, match="one token"):
        tnn.mamba2_decode(tp, torch.zeros(1, 2, DIM), st, n_heads=HEADS, d_state=STATE)


# ---------------------------------------------------------------- models --

def test_config_matches_reference():
    for j, t in ((JARCHS[NAME], ARCHS[NAME]), (JARCHS[NAME].smoke(), ARCHS[NAME].smoke())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
    assert models._mod(ARCHS[NAME]) is zamba and zamba.n_groups(ARCHS[NAME]) == 9


def test_init_model_layout_and_parameter_count():
    cfg = ARCHS[NAME].smoke()
    model = models.init_model(0, cfg, device="cpu")
    assert len(model.mamba_layers) == zamba.n_groups(cfg)
    assert all(len(g) == cfg.attn_every for g in model.mamba_layers)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(jmodels.init_model(KEY, JARCHS[NAME]
                                                                       .smoke())))


def test_n_groups_refuses_a_ragged_stack():
    with pytest.raises(ValueError, match="attn_every 4"):
        zamba.n_groups(ARCHS[NAME].replace(n_layers=6, attn_every=4))


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_reference(use_flash):
    jcfg, tcfg, jp, model = pair(use_flash)
    jb, tb = batches(tcfg.vocab, 2, 16)
    jl, _ = jmodels.forward(jp, jb, jcfg)
    with torch.no_grad():
        tl, aux = models.forward(model, tb, tcfg)
    assert tl.shape == (2, 16, tcfg.vocab) and float(aux["lb_loss"]) == 0.0
    assert err(jl, tl) < (KERNEL_TOL if use_flash else PLAIN_TOL)
    with torch.no_grad():
        last, _ = models.forward(model, tb, tcfg, last_only=True)
    assert torch.allclose(last[:, 0], tl[:, -1], atol=1e-6)


@pytest.mark.parametrize("use_flash", [False, True])
def test_decode_steps_match_reference(use_flash):
    """Four chained decode steps from the reference's cache, carried
    across with ``cache_from_numpy``."""
    jcfg, tcfg, jp, model = pair(use_flash)
    jb, tb = batches(tcfg.vocab, 2, 4, seed=1)
    jcache = jmodels.init_cache(jcfg, 2, 8)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache))
    assert tcache["ssm"].dtype == torch.float32 and tcache["conv"].shape[3] == 3
    for i in range(4):
        jl, jcache = jmodels.decode_step(jp, {"tokens": jb["tokens"][:, i:i + 1]}, jcache,
                                         jcfg)
        with torch.no_grad():
            tl, tcache = models.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]},
                                            tcache, tcfg)
        assert err(jl, tl) < (KERNEL_TOL if use_flash else PLAIN_TOL), i
    tol = KERNEL_TOL if use_flash else PLAIN_TOL      # two layers deep, as the logits
    for k in ("k", "v", "ssm", "conv"):
        assert err(jcache[k], tcache[k]) < tol, k
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() == [4, 4]


def test_decode_equals_teacher_forced_forward():
    _, tcfg, _, model = pair()
    _, tb = batches(tcfg.vocab, 2, 6, seed=2)
    with torch.no_grad():
        full, _ = models.forward(model, tb, tcfg)
        cache = models.init_cache(tcfg, 2, 8, device="cpu")
        for i in range(6):
            lg, cache = models.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]},
                                           cache, tcfg)
            assert torch.allclose(lg[:, 0], full[:, i], atol=PLAIN_TOL), i


def test_prefill_step_runs_the_forward_only():
    """hybrid prefill: (last logits, aux), as the reference's."""
    jcfg, tcfg, jp, model = pair()
    jb, tb = batches(tcfg.vocab, 2, 8, seed=3)
    jl, jaux = jsteps.make_prefill_step(jcfg)(jp, jb)
    with torch.no_grad():
        tl, taux = steps.make_prefill_step(tcfg)(model, tb)
    assert tl.shape == (2, tcfg.vocab) and err(jl, tl) < PLAIN_TOL
    assert set(taux) == set(jaux) == {"lb_loss", "dropped_frac"}


# -------------------------------------------------------------- executor --

@pytest.mark.parametrize("quant", ["bf16", "int8", "int4"])
def test_quantize_params_matches_reference(quant):
    """One scale per reference leaf: every mamba layer's leaf of
    ``mamba_layers`` [G, attn_every, ...] shares it, the shared block's
    own leaves do not."""
    cfg, jcfg = ARCHS[NAME].smoke(), JARCHS[NAME].smoke()
    jp = jmodels.init_model(KEY, jcfg)
    model = executor.quantize_params(carry(models.init_model(0, cfg, device="cpu"), jp),
                                     quant)
    want = carry(models.init_model(0, cfg, device="cpu"), jax.tree.map(
        lambda x: np.asarray(x, np.float32), jexecutor.quantize_params(jp, quant)))
    for (n, got), (_, ref) in zip(model.named_parameters(), want.named_parameters(),
                                  strict=True):
        assert got.dtype == torch.bfloat16 and torch.equal(got.float(), ref), n


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_quantised_serve_step_matches_reference(quant):
    jcfg, cfg = JARCHS[NAME].smoke(), ARCHS[NAME].smoke()
    jp = jexecutor.quantize_params(jmodels.init_model(jax.random.PRNGKey(2), jcfg), quant)
    model = carry(models.init_model(0, cfg, device="cpu"),
                  jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    executor.quantize_params(model, "bf16")
    jshape, shape = JShape("serve_b3", 8, 3, "decode"), InputShape("serve_b3", 8, 3, "decode")
    jcache = jmodels.init_cache(jcfg, 3, 8)
    tcache = models.init_cache(cfg, 3, 8, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 1)).astype(np.int32)
    jl, _ = jax.jit(jsteps.make_serve_step(jcfg, jshape))(jp, {"tokens": jnp.asarray(toks)},
                                                          jcache)
    with torch.inference_mode():
        tl, new = steps.make_serve_step(cfg, shape)(model, {"tokens": torch.from_numpy(toks)},
                                                    tcache)
    want = np.asarray(jl, dtype=np.float32)
    assert tl.dtype == torch.bfloat16 and new["ssm"].dtype == torch.float32
    assert np.abs(want - tl.float().numpy()).max() <= QUANT_TOL * np.abs(want).max()


def test_step_bytes_reads_and_writes_the_recurrent_state():
    """zamba's ``ssm`` and ``conv`` are read and rewritten by every step:
    counted twice; its k/v (per shared-block application) as the dense
    family's, one valid slot read and one written per row."""
    ex = executor.StageExecutor("cpu", seq_len=8, smoke=True)
    t = ex.measure(NAME, 2, "bf16", reps=1, warmup=0)
    entry = ex.cache.entries[ex.key_for(NAME, 2, "bf16")]
    model, cache = entry.model, entry.cache
    emb = model.embed.e
    weights = sum(p.numel() * p.element_size() for p in model.parameters()) - emb.nbytes
    k = cache["k"]                                   # [G, B, C, kv, hd]
    slot = k.nbytes // (k.shape[1] * k.shape[2])
    kv = 2 * (2 * slot + 2 * slot)                   # k and v: one valid slot + one written
    state = 2 * (cache["ssm"].nbytes + cache["conv"].nbytes)
    logits = 2 * 1 * ex.arch_config(NAME).vocab * 2
    assert t.bytes == weights + 2 * emb.shape[1] * 2 + kv + state + logits
    assert entry.launches == {} and t.flops > 0.0
