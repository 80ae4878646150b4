"""Port's audio (whisper-small) and ssm (xlstm-125m) families vs the JAX
reference on the CPU, at smoke size with the reference's weights carried
across through ``models/convert.py``.

Tolerances: forward and chained decode logits within 1e-4 (f32, two
layers, the same arithmetic in another summation order); the mLSTM and
sLSTM blocks and cross-attention within 1e-5 (one block, f32); whisper's
self-attention through the kernels' plain versions within 5e-3 against the
Pallas kernels in interpret mode (as ``tests/test_torch_models.py``). The
live executors serve the whole of serve2 token for token, with one set of
encoder states handed to both packages (``jax.random`` cannot be
reproduced in torch).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.api import session as jsession  # noqa: E402
from repro.cluster import env as jenv  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.models import api as jmodels  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.serving import arrivals as jarrivals  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.cluster import env  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.models import api as models  # noqa: E402
from repro_torch.models import whisper, xlstm_lm  # noqa: E402
from repro_torch.models.convert import cache_from_numpy, load_jax_params  # noqa: E402
from repro_torch.serving import arrivals, engine  # noqa: E402

NAMES = ["whisper-small", "xlstm-125m"]
PLAIN_TOL, BLOCK_TOL, KERNEL_TOL = 1e-4, 1e-5, 5e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size models: one intra-op thread runs them about as fast as a
    pool, whose threads would contend with other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(module, jparams):
    return load_jax_params(module, jax.tree.map(np.asarray, jparams))


def pair(name, use_flash=False):
    jcfg = JARCHS[name].smoke().replace(use_flash=use_flash)
    tcfg = ARCHS[name].smoke().replace(use_flash=use_flash)
    jp = jmodels.init_model(KEY, jcfg)
    return jcfg, tcfg, jp, carry(models.init_model(1, tcfg, device="cpu"), jp)


def enc_states(B, cfg, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, cfg.enc_len, cfg.d_model))
            * 0.02).astype(np.float32)


def batches(cfg, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "audio":
        e = enc_states(B, cfg, seed)
        jb["enc_states"], tb["enc_states"] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


def err(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float32) - b.detach().float().numpy()).max())


def rand(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# --------------------------------------------------------------- models --

@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    for j, t in ((JARCHS[name], ARCHS[name]), (JARCHS[name].smoke(), ARCHS[name].smoke())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
    assert models._mod(ARCHS[name]) is {"audio": whisper, "ssm": xlstm_lm}[ARCHS[name].family]


@pytest.mark.parametrize("name", NAMES)
def test_init_model_matches_reference_parameter_count(name):
    cfg = ARCHS[name].smoke()
    a, b = (models.init_model(0, cfg, device="cpu") for _ in range(2))
    assert torch.equal(a.lm_head.w, b.lm_head.w)
    assert abs(float(a.embed.e.std()) - 0.02) < 2e-3
    n = sum(p.numel() for p in a.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(
        jmodels.init_model(KEY, JARCHS[name].smoke())))


@pytest.mark.parametrize("name,use_flash", [("whisper-small", False), ("xlstm-125m", False),
                                            ("whisper-small", True)])
def test_forward_matches_reference(name, use_flash):
    jcfg, tcfg, jp, model = pair(name, use_flash)
    jb, tb = batches(tcfg, 2, 12)
    jl, _ = jmodels.forward(jp, jb, jcfg)
    with torch.no_grad():
        tl, aux = models.forward(model, tb, tcfg)
    assert tl.shape == (2, 12, tcfg.vocab) and float(aux["lb_loss"]) == 0.0
    assert err(jl, tl) < (KERNEL_TOL if use_flash else PLAIN_TOL)
    with torch.no_grad():
        last, _ = models.forward(model, tb, tcfg, last_only=True)
    assert torch.allclose(last[:, 0], tl[:, -1], atol=1e-6)


@pytest.mark.parametrize("name,use_flash", [("whisper-small", False), ("xlstm-125m", False),
                                            ("whisper-small", True)])
def test_decode_steps_match_reference(name, use_flash):
    """Six chained decode steps from the reference's cache (whisper's cross
    KV prefilled from the encoder states); logits at every step."""
    jcfg, tcfg, jp, model = pair(name, use_flash)
    jb, tb = batches(tcfg, 2, 6, seed=1)
    if tcfg.family == "audio":
        jcache = jwhisper.prefill_cache(jp, jb, jcfg, 8)
        with torch.no_grad():
            tcache = whisper.prefill_cache(model, tb, tcfg, 8)
        assert err(jcache["ck"], tcache["ck"]) < BLOCK_TOL
    else:
        jcache = jmodels.init_cache(jcfg, 2, 8)
        tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache))
        assert torch.isinf(tcache["states"][0]["m"]).all()
    for i in range(6):
        jl, jcache = jmodels.decode_step(jp, {"tokens": jb["tokens"][:, i:i + 1]}, jcache, jcfg)
        with torch.no_grad():
            tl, tcache = models.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]},
                                            tcache, tcfg)
        assert err(jl, tl) < (KERNEL_TOL if use_flash else PLAIN_TOL), i
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() == [6, 6]


@pytest.mark.parametrize("name", NAMES)
def test_decode_equals_teacher_forced_forward(name):
    """The port against itself: decoding token by token reproduces the
    full-sequence forward's logits."""
    _, tcfg, _, model = pair(name)
    _, tb = batches(tcfg, 2, 5, seed=2)
    with torch.no_grad():
        full, _ = models.forward(model, tb, tcfg)
        cache = (whisper.prefill_cache(model, tb, tcfg, 8) if tcfg.family == "audio"
                 else models.init_cache(tcfg, 2, 8, device="cpu"))
        for i in range(5):
            lg, cache = models.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]},
                                           cache, tcfg)
            assert torch.allclose(lg[:, 0], full[:, i], atol=PLAIN_TOL), i


# ---------------------------------------------------------------- xLSTM --

DIM, HEADS = 32, 4


def mlstm_pair(seed=3):
    jp = jnn.init_mlstm(jax.random.PRNGKey(seed), DIM, HEADS)
    return jp, carry(tnn.MLSTM(DIM, HEADS), jp)


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 8), (16, 16)])
def test_mlstm_chunkwise_matches_reference_chunkwise_and_parallel(S, chunk):
    """Chunk edges carry the stabiliser m (-inf before the first chunk)
    exactly as the reference's chunkwise and parallel forms."""
    jp, tp = mlstm_pair()
    x = rand((2, S, DIM), S)
    jc, jcs = jnn.mlstm_chunkwise(jp, jnp.asarray(x), n_heads=HEADS, chunk=chunk,
                                  return_state=True)
    jpar, jps = jnn.mlstm_parallel(jp, jnp.asarray(x), n_heads=HEADS, return_state=True)
    with torch.no_grad():
        tc, tcs = tnn.mlstm_chunkwise(tp, torch.from_numpy(x), n_heads=HEADS, chunk=chunk,
                                      return_state=True)
    assert err(jc, tc) < BLOCK_TOL and err(jpar, tc) < BLOCK_TOL
    for k in ("C", "n", "m"):
        assert err(jcs[k], tcs[k]) < BLOCK_TOL and err(jps[k], tcs[k]) < BLOCK_TOL, k


def test_mlstm_chunkwise_refuses_ragged_sequence():
    _, tp = mlstm_pair()
    with pytest.raises(ValueError, match="not divisible"):
        tnn.mlstm_chunkwise(tp, torch.zeros(1, 20, DIM), n_heads=HEADS, chunk=8)


def test_mlstm_decode_steps_match_reference_parallel_form():
    """Decoding S tokens one by one gives the parallel form's outputs and
    its final (C, n, m) state, in the port and the reference alike."""
    jp, tp = mlstm_pair(4)
    S = 7
    x = rand((2, S, DIM), 9)
    jpar, jps = jnn.mlstm_parallel(jp, jnp.asarray(x), n_heads=HEADS, return_state=True)
    jst = jnn.make_mlstm_state(2, DIM, HEADS)
    tst = tnn.make_mlstm_state(2, DIM, HEADS)
    for t in range(S):
        jy, jst = jnn.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, n_heads=HEADS)
        with torch.no_grad():
            ty, tst = tnn.mlstm_decode(tp, torch.from_numpy(x[:, t:t + 1]), tst,
                                       n_heads=HEADS)
        assert err(jy, ty) < BLOCK_TOL and err(jpar[:, t:t + 1], ty) < BLOCK_TOL, t
    for k in ("C", "n", "m"):
        assert err(jst[k], tst[k]) < BLOCK_TOL and err(jps[k], tst[k]) < BLOCK_TOL, k


def test_slstm_scan_and_decode_match_reference():
    jp = jnn.init_slstm(jax.random.PRNGKey(5), DIM, HEADS)
    tp = carry(tnn.SLSTM(DIM, HEADS), jp)
    S = 9
    x = rand((2, S, DIM), 11)
    jy, jfin = jnn.slstm_scan(jp, jnp.asarray(x), n_heads=HEADS, return_state=True)
    with torch.no_grad():
        ty, tfin = tnn.slstm_scan(tp, torch.from_numpy(x), n_heads=HEADS, return_state=True)
    assert err(jy, ty) < BLOCK_TOL
    for k in ("c", "n", "h", "m"):
        assert err(jfin[k], tfin[k]) < BLOCK_TOL, k
    jst = jnn.make_slstm_state(2, DIM, HEADS)
    tst = tnn.make_slstm_state(2, DIM, HEADS)
    for t in range(S):
        jd, jst = jnn.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, n_heads=HEADS)
        with torch.no_grad():
            td, tst = tnn.slstm_decode(tp, torch.from_numpy(x[:, t:t + 1]), tst, n_heads=HEADS)
        assert err(jd, td) < BLOCK_TOL and err(jy[:, t:t + 1], td) < BLOCK_TOL, t


def test_slstm_long_scan_takes_the_chunked_reference_path():
    """S > 64 and a multiple of it: the reference's two-level scan; the
    port's single loop gives the same outputs."""
    jp = jnn.init_slstm(jax.random.PRNGKey(6), DIM, HEADS)
    tp = carry(tnn.SLSTM(DIM, HEADS), jp)
    x = rand((1, 128, DIM), 12)
    jy = jnn.slstm_scan(jp, jnp.asarray(x), n_heads=HEADS)
    with torch.no_grad():
        ty = tnn.slstm_scan(tp, torch.from_numpy(x), n_heads=HEADS)
    assert err(jy, ty) < BLOCK_TOL


def test_cross_attention_matches_reference():
    from repro.nn import attention as jattn
    jp = jattn.init_cross_attention(jax.random.PRNGKey(7), DIM, HEADS, DIM // HEADS)
    tp = carry(tnn.init_cross_attention(DIM, HEADS, DIM // HEADS), jp)
    x, enc = rand((2, 5, DIM), 13), rand((2, 11, DIM), 14)
    jy = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(enc), n_heads=HEADS,
                               head_dim=DIM // HEADS)
    with torch.no_grad():
        ty = tnn.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(enc),
                                 n_heads=HEADS, head_dim=DIM // HEADS)
    assert ty.shape == (2, 5, DIM) and err(jy, ty) < BLOCK_TOL


# ---------------------------------------------------- live serve2 stages --

def test_stage_server_draws_encoder_states_for_audio():
    cfg = ARCHS["whisper-small"].smoke()
    server = engine.StageServer("s0", [cfg], device="cpu")
    toks = np.zeros((3, 4), dtype=np.int32)
    a, b = server._make_batch(toks, cfg), server._make_batch(toks, cfg)
    assert a["enc_states"].shape == (3, cfg.enc_len, cfg.d_model)
    assert a["enc_states"].dtype == torch.float32 and torch.equal(a["enc_states"],
                                                                  b["enc_states"])
    assert abs(float(a["enc_states"].std()) - 0.02) < 5e-3
    assert "enc_states" not in server._make_batch(toks, ARCHS["xlstm-125m"].smoke())


def shared_encoder_states(monkeypatch):
    """Both packages' stage servers draw the same NumPy encoder states."""
    def patched(jax_side, original):
        def make_batch(self, tokens, cfg):
            batch = original(self, tokens, cfg)
            if cfg.family == "audio":
                e = enc_states(tokens.shape[0], cfg, seed=tokens.shape[0])
                batch["enc_states"] = jnp.asarray(e) if jax_side else torch.from_numpy(e)
            return batch
        return make_batch
    monkeypatch.setattr(jengine.StageServer, "_make_batch",
                        patched(True, jengine.StageServer._make_batch))
    monkeypatch.setattr(engine.StageServer, "_make_batch",
                        patched(False, engine.StageServer._make_batch))


REF = SimpleNamespace(api=japi, env=jenv, arrivals=jarrivals, baselines=jbaselines)
PORT = SimpleNamespace(api=api, env=env, arrivals=arrivals, baselines=baselines)


def serve2_spec(ns, horizon=20):
    return ns.api.ExperimentSpec(
        pipeline=ns.api.get_pipeline("serve2"),
        scenario=ns.api.replace(ns.api.get_scenario("bursty"), seed=3, horizon=horizon),
        controller=ns.api.replace(ns.api.get_controller("random"), seed=0), real=True)


def test_live_serve2_token_for_token(monkeypatch):
    """The whole of serve2 served live (whisper/xLSTM, then llama/starcoder)
    by smoke executors with carried weights: every stage output equals the
    reference's, and the virtual-time results are identical."""
    shared_encoder_states(monkeypatch)
    jexec = jsession.build_executors(serve2_spec(REF))
    sess = api.Session(serve2_spec(PORT), device="cpu", smoke=True)
    for server, je in zip(sess.stage_servers(), jexec, strict=True):
        for model, jp in zip(server.params, je.__self__.params, strict=True):
            carry(model, jp)
    calls, outs = [], []

    def recorded(i, fn):
        def run(z, tokens):
            calls.append((i, int(z)))
            return fn(z, tokens)
        return run

    port_exec = [recorded(i, s.execute) for i, s in enumerate(sess.stage_servers())]
    for ns, execs in ((REF, jexec), (PORT, port_exec)):
        pipe = ns.api.get_pipeline("serve2").build()
        e = ns.env.RuntimeEnv(pipe, ns.arrivals.make_arrivals("bursty", seed=3),
                              horizon=20, executors=execs)
        ctrl = ns.baselines.RandomPolicy(pipe, seed=0)
        done, rewards = False, []
        while not done:
            _, r, done, _ = e.step(ctrl.decide(e.observe()))
            rewards.append(r)
        summary = e.drain()
        outs.append((rewards, summary, [(r.rid, np.stack(r.stage_outputs))
                                        for r in e.runtime.completed]))
    (jr, js, jo), (tr, ts, to) = outs
    assert tr == jr and ts == js
    assert len(to) == len(jo) == ts["served"] > 0
    assert set(calls) == {(i, z) for i in range(2) for z in (0, 1)}
    for (jrid, jout), (trid, tout) in zip(jo, to, strict=True):
        assert trid == jrid and tout.dtype == np.int32 and tout.shape == (2, 32)
        assert np.array_equal(tout, jout), f"request {trid}: stage outputs differ"


def test_prefill_step_of_whisper_prefills_the_cross_cache():
    """audio prefill: the forward's last logits and the cross-attention
    cache from the encoder states, as the reference's."""
    from repro.models import steps as jsteps
    from repro_torch.models import steps
    jcfg, tcfg, jp, model = pair("whisper-small")
    jb, tb = batches(tcfg, 2, 6, seed=4)
    jl, jcache = jsteps.make_prefill_step(jcfg)(jp, jb)
    with torch.no_grad():
        tl, tcache = steps.make_prefill_step(tcfg)(model, tb)
    assert tl.shape == (2, tcfg.vocab) and err(jl, tl) < PLAIN_TOL
    assert tcache["k"].shape[2] == 6 and tcache["pos"].tolist() == [0, 0]
    for k in ("ck", "cv"):
        assert err(jcache[k], tcache[k]) < BLOCK_TOL, k
