"""Port's MoE layer and moe family (granite-moe-3b-a800m, llama4's MoE
interleave) vs the JAX reference on the CPU, at smoke size with the
reference's weights carried across through ``models/convert.py``; and
serve3 served live token for token against the reference's executors.

Tolerances: the MoE layer's output and both aux values within 1e-5 (one
layer, f32); forward and chained decode logits within 1e-4 on the plain
path and 5e-3 with the kernels' plain versions against the Pallas kernels
in interpret mode (as ``tests/test_torch_models.py``); quantised serve
steps within 4e-2 of max-abs (as ``tests/test_torch_calibration.py``).
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_families import PORT, REF, carry, shared_encoder_states  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.api import session as jsession  # noqa: E402
from repro.cluster import executor as jexecutor  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import api as jmodels  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models.config import InputShape as JShape  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.cluster import executor  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import api as models  # noqa: E402
from repro_torch.models import decoder, steps  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.models.convert import cache_from_numpy  # noqa: E402

# the packages export the function ``moe`` under the module's name
jmoe = importlib.import_module("repro.nn.moe")
tmoe = importlib.import_module("repro_torch.nn.moe")
NAMES = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
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


def pair(name, use_flash=False):
    jcfg = JARCHS[name].smoke().replace(use_flash=use_flash)
    tcfg = ARCHS[name].smoke().replace(use_flash=use_flash)
    jp = jmodels.init_model(KEY, jcfg)
    return jcfg, tcfg, jp, carry(models.init_model(1, tcfg, device="cpu"), jp)


def batches(vocab, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


# -------------------------------------------------------------- the layer --

DIM, HIDDEN = 32, 48


def moe_pair(n_experts, seed=3):
    jp = jnn.init_moe(jax.random.PRNGKey(seed), DIM, HIDDEN, n_experts)
    return jp, carry(tnn.MoE(DIM, HIDDEN, n_experts), jp)


def repeated_tokens(B, S, seed):
    """S tokens made of S // 4 distinct rows, each repeated 4 times: equal
    non-zero gates compete for one expert's capacity slots."""
    base = np.random.default_rng(seed).standard_normal((B, S // 4, DIM)).astype(np.float32)
    return np.repeat(base, 4, axis=1)


MOE_CASES = {
    # E < 16: no padding
    "e4_top2": dict(E=4, k=2, S=12, cf=1.25, x="normal"),
    # E >= 16: 40 experts padded to 48, granite-moe's top-8
    "e40_top8_padded": dict(E=40, k=8, S=16, cf=1.25, x="normal"),
    # a small capacity factor: tokens overflow their experts' slots
    "overflow": dict(E=8, k=2, S=24, cf=0.5, x="normal"),
    # identical tokens: the tie order decides which token keeps a slot
    "repeated_tokens": dict(E=4, k=1, S=16, cf=1.25, x="repeated"),
}


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_matches_reference(case):
    c = MOE_CASES[case]
    jp, tp = moe_pair(c["E"])
    assert tp.experts.wg.shape == (tmoe._phys_experts(c["E"]), DIM, HIDDEN)
    assert tp.router.w.dtype == torch.float32
    x = (repeated_tokens(2, c["S"], 5) if c["x"] == "repeated" else
         np.random.default_rng(4).standard_normal((2, c["S"], DIM)).astype(np.float32))
    jy, jaux = jnn.moe(jp, jnp.asarray(x), top_k=c["k"], capacity_factor=c["cf"])
    with torch.no_grad():
        ty, taux = tnn.moe(tp, torch.from_numpy(x), top_k=c["k"], capacity_factor=c["cf"])
        gsel, tok, _, C = tmoe._route(tp, torch.from_numpy(x), top_k=c["k"],
                                      capacity_factor=c["cf"],
                                      E_phys=tp.experts.wg.shape[0])
    assert ty.shape == x.shape and ty.dtype == torch.float32
    assert err(jy, ty) < BLOCK_TOL
    for k in ("lb_loss", "dropped_frac"):
        assert abs(float(jaux[k]) - float(taux[k])) < BLOCK_TOL, k
    jg, jt, _, jC = jmoe._route(jp, jnp.asarray(x), top_k=c["k"], capacity_factor=c["cf"],
                                E_phys=tp.experts.wg.shape[0])
    assert C == jC and np.array_equal(np.asarray(jt), tok.numpy())
    assert err(jg, gsel) < BLOCK_TOL
    if case == "overflow":
        # fewer slots used than the B·S·k choices made: tokens were dropped
        assert (gsel > 0).sum().item() < 2 * c["S"] * c["k"]
        assert float(taux["dropped_frac"]) > 0.0
    if case == "repeated_tokens":
        # a tie at the capacity edge: equal non-zero gates on both sides of it
        with torch.no_grad():
            every, *_ = tmoe._route(tp, torch.from_numpy(x), top_k=1,
                                    capacity_factor=c["E"], E_phys=c["E"])
        edge = (every[..., C - 1] == every[..., C]) & (every[..., C] > 0)
        assert bool(edge.any())


def test_moe_need_aux_false_returns_the_same_output():
    jp, tp = moe_pair(40)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 1, DIM))
                         .astype(np.float32))
    with torch.no_grad():
        y, aux = tnn.moe(tp, x, top_k=8)
        y2, none = tnn.moe(tp, x, top_k=8, need_aux=False)
    assert torch.equal(y, y2) and none is None and set(aux) == {"lb_loss", "dropped_frac"}


@pytest.mark.parametrize("n,want", [(4, 4), (15, 15), (16, 16), (40, 48), (128, 128)])
def test_phys_experts_matches_reference(n, want):
    assert tmoe._phys_experts(n) == jmoe._phys_experts(n) == want


def test_moe_bf16_input_combines_in_f32_and_casts_back():
    jp, tp = moe_pair(4)
    x = np.random.default_rng(7).standard_normal((2, 8, DIM)).astype(np.float32)
    jy, _ = jnn.moe(jp, jnp.asarray(x).astype(jnp.bfloat16), top_k=2)
    with torch.no_grad():
        ty, _ = tnn.moe(tp, torch.from_numpy(x).to(torch.bfloat16), top_k=2)
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert err(jy, ty) < QUANT_TOL


# ---------------------------------------------------------------- models --

@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    for j, t in ((JARCHS[name], ARCHS[name]), (JARCHS[name].smoke(), ARCHS[name].smoke())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.param_count() == t.param_count()
        assert j.active_param_count() == t.active_param_count()
    assert models._mod(ARCHS[name]) is decoder


@pytest.mark.parametrize("name", NAMES)
def test_init_model_matches_reference_parameter_count(name):
    cfg = ARCHS[name].smoke()
    model = models.init_model(0, cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(jmodels.init_model(KEY, JARCHS[name]
                                                                       .smoke())))
    if cfg.moe_every > 1:            # llama4: sub0 dense, sub1 MoE
        assert len(model.layers) == cfg.n_layers // cfg.moe_every
        assert hasattr(model.layers[0].sub0, "mlp") and hasattr(model.layers[0].sub1, "moe")


@pytest.mark.parametrize("name,use_flash", [(NAMES[0], False), (NAMES[1], False),
                                            (NAMES[0], True)])
def test_forward_matches_reference(name, use_flash):
    jcfg, tcfg, jp, model = pair(name, use_flash)
    jb, tb = batches(tcfg.vocab, 2, 12)
    jl, jaux = jmodels.forward(jp, jb, jcfg)
    with torch.no_grad():
        tl, taux = models.forward(model, tb, tcfg)
    tol = KERNEL_TOL if use_flash else PLAIN_TOL
    assert tl.shape == (2, 12, tcfg.vocab) and err(jl, tl) < tol
    for k in ("lb_loss", "dropped_frac"):
        assert abs(float(jaux[k]) - float(taux[k])) < BLOCK_TOL, k
    assert float(taux["lb_loss"]) > 0.0


@pytest.mark.parametrize("name,use_flash", [(NAMES[0], False), (NAMES[1], False),
                                            (NAMES[0], True)])
def test_decode_steps_match_reference(name, use_flash):
    """Four chained decode steps from the reference's empty cache."""
    jcfg, tcfg, jp, model = pair(name, use_flash)
    jb, tb = batches(tcfg.vocab, 2, 4, seed=1)
    jcache = jmodels.init_cache(jcfg, 2, 8)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache))
    for i in range(4):
        jl, jcache = jmodels.decode_step(jp, {"tokens": jb["tokens"][:, i:i + 1]}, jcache,
                                         jcfg)
        with torch.no_grad():
            tl, tcache = models.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]},
                                            tcache, tcfg)
        assert err(jl, tl) < (KERNEL_TOL if use_flash else PLAIN_TOL), i
    assert err(jcache["k"], tcache["k"]) < (KERNEL_TOL if use_flash else PLAIN_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_equals_teacher_forced_forward(name, monkeypatch):
    """The port against itself: the prefill step's cache, then decode, gives
    the full forward's logits at the later positions. A decode step routes
    its one token to all k of its experts (C = 1 of S = 1), while a
    forward's capacity can drop tokens, so the forward runs here at a
    capacity factor of E / k, where every choice fits (C = S)."""
    _, tcfg, _, model = pair(name)
    monkeypatch.setattr(tnn, "moe", functools.partial(
        tmoe.moe, capacity_factor=tcfg.n_experts / tcfg.top_k))
    _, tb = batches(tcfg.vocab, 2, 8, seed=2)
    with torch.no_grad():
        full, _ = models.forward(model, tb, tcfg)
        last, pre = steps.make_prefill_step(tcfg)(model, {"tokens": tb["tokens"][:, :5]})
    assert pre["k"].shape[:3] == (tcfg.n_layers, 2, 5) and pre["pos"].tolist() == [5, 5]
    assert torch.allclose(last, full[:, 4], atol=PLAIN_TOL)
    cache = models.init_cache(tcfg, 2, 8, device="cpu")
    cache["k"][:, :, :5], cache["v"][:, :, :5], cache["pos"] = pre["k"], pre["v"], pre["pos"]
    for i in range(5, 8):
        with torch.no_grad():
            lg, cache = models.decode_step(model, {"tokens": tb["tokens"][:, i:i + 1]},
                                           cache, tcfg)
        assert torch.allclose(lg[:, 0], full[:, i], atol=PLAIN_TOL), i


def test_prefill_step_matches_reference():
    jcfg, tcfg, jp, model = pair(NAMES[0])
    jb, tb = batches(tcfg.vocab, 2, 6, seed=3)
    jl, jcache = jsteps.make_prefill_step(jcfg)(jp, jb)
    with torch.no_grad():
        tl, tcache = steps.make_prefill_step(tcfg)(model, tb)
    assert err(jl, tl) < PLAIN_TOL
    for k in ("k", "v"):
        assert err(jcache[k], tcache[k]) < PLAIN_TOL, k
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


@pytest.mark.parametrize("quant", ["bf16", "int8", "int4"])
def test_quantize_params_matches_reference(quant):
    """One scale per stacked expert leaf [L, E_phys, ...], as the reference."""
    cfg, jcfg = ARCHS[NAMES[0]].smoke(), JARCHS[NAMES[0]].smoke()
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
    """bf16 activations, rounded after every op on both sides: the
    reference runs op by op here, because under ``jax.jit`` XLA fuses bf16
    elementwise chains in f32, which moves a hidden state by a bf16 ulp, and
    a routing choice near a tie (two experts' probabilities 0.2795 and
    0.2764 at this seed) then flips and changes the row's output."""
    jcfg, cfg = JARCHS[NAMES[0]].smoke(), ARCHS[NAMES[0]].smoke()
    jp = jexecutor.quantize_params(jmodels.init_model(jax.random.PRNGKey(2), jcfg), quant)
    model = carry(models.init_model(0, cfg, device="cpu"),
                  jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    executor.quantize_params(model, "bf16")
    jshape, shape = JShape("serve_b3", 8, 3, "decode"), InputShape("serve_b3", 8, 3, "decode")
    jcache = jmodels.init_cache(jcfg, 3, 8)
    tcache = models.init_cache(cfg, 3, 8, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 1)).astype(np.int32)
    with jax.disable_jit():
        jl, _ = jsteps.make_serve_step(jcfg, jshape)(jp, {"tokens": jnp.asarray(toks)},
                                                     jcache)
    with torch.inference_mode():
        tl, _ = steps.make_serve_step(cfg, shape)(model, {"tokens": torch.from_numpy(toks)},
                                                  tcache)
    want = np.asarray(jl, dtype=np.float32)
    assert tl.dtype == torch.bfloat16
    assert np.abs(want - tl.float().numpy()).max() <= QUANT_TOL * np.abs(want).max()


# ------------------------------------------------------- live serve3 stages --

SERVE3_HORIZON, SERVE3_SEED = 30, 2     # the random policy picks each variant of each stage


def serve3_spec(ns):
    return ns.api.ExperimentSpec(
        pipeline=ns.api.get_pipeline("serve3"),
        scenario=ns.api.replace(ns.api.get_scenario("bursty"), seed=3,
                                horizon=SERVE3_HORIZON),
        controller=ns.api.replace(ns.api.get_controller("random"), seed=SERVE3_SEED),
        real=True)


def test_live_serve3_token_for_token(monkeypatch):
    """The whole of serve3 served live (xLSTM/whisper, llama/starcoder, then
    granite-moe/zamba2) by smoke executors with carried weights; the
    virtual-time results are identical to the reference's. Every call of a
    port executor runs on the tokens the reference's executor got and
    gives its output token for token, except at a position where the
    reference's two best logits lie within the logits tolerance, where
    float rounding decides the argmax (one such position in this run, a
    gap of 2.1e-6 among 77,088 tokens); the reference's output then travels on, so each stage
    sees the reference's inputs. Stage 1 also hands stage 2 rows of one
    repeated token, whose positions are equal up to rounding, and which of
    them keeps an expert's capacity slot then turns on the last bit (see
    ``nn/moe.py``): so both packages route here at a capacity factor of
    E / k, where every choice fits; ``test_moe_matches_reference`` holds
    the capacity itself."""
    shared_encoder_states(monkeypatch)
    cfg = ARCHS[NAMES[0]].smoke()
    cf = cfg.n_experts / cfg.top_k
    monkeypatch.setattr(jnn, "moe", functools.partial(jmoe.moe, capacity_factor=cf))
    monkeypatch.setattr(tnn, "moe", functools.partial(tmoe.moe, capacity_factor=cf))
    jexec = jsession.build_executors(serve3_spec(REF))
    sess = api.Session(serve3_spec(PORT), device="cpu", smoke=True)
    for server, je in zip(sess.stage_servers(), jexec, strict=True):
        for model, jp in zip(server.params, je.__self__.params, strict=True):
            carry(model, jp)
    ref_calls, near_ties = [], []

    def recorded(i, fn):
        def run(z, tokens):
            out = np.asarray(fn(z, tokens))
            ref_calls.append((i, int(z), tokens.copy(), out))
            return out
        return run

    def held(i, fn):
        def run(z, tokens):
            ri, rz, rtokens, rout = ref_calls[len(calls)]
            calls.append((i, int(z)))
            assert (i, int(z)) == (ri, rz) and np.array_equal(tokens, rtokens)
            out = fn(z, tokens)
            assert out.dtype == np.int32 and out.shape == rout.shape
            for row, pos in zip(*np.nonzero(out != rout), strict=True):
                near_ties.append(reference_gap(jexec[i].__self__, rz, rtokens, row, pos))
            return rout
        return run

    calls, outs = [], []
    jrec = [recorded(i, fn) for i, fn in enumerate(jexec)]
    port_exec = [held(i, s.execute) for i, s in enumerate(sess.stage_servers())]
    for ns, execs in ((REF, jrec), (PORT, port_exec)):
        pipe = ns.api.get_pipeline("serve3").build()
        e = ns.env.RuntimeEnv(pipe, ns.arrivals.make_arrivals("bursty", seed=3),
                              horizon=SERVE3_HORIZON, executors=execs)
        ctrl = ns.baselines.RandomPolicy(pipe, seed=SERVE3_SEED)
        done, rewards = False, []
        while not done:
            _, r, done, _ = e.step(ctrl.decide(e.observe()))
            rewards.append(r)
        outs.append((rewards, e.drain(), len(e.runtime.completed)))
    (jr, js, jn), (tr, ts, tn) = outs
    assert tr == jr and ts == js and tn == jn == ts["served"] > 0
    assert len(calls) == len(ref_calls)
    assert set(calls) == {(i, z) for i in range(3) for z in (0, 1)}
    n_tokens = sum(out.size for *_, out in ref_calls)
    assert len(near_ties) <= 1e-3 * n_tokens and max(near_ties, default=0.0) < PLAIN_TOL


def reference_gap(server, z, tokens, row, pos) -> float:
    """The gap between the reference's two best logits at (row, pos)."""
    cfg = server.variants[z]
    logits, _ = jmodels.forward(server.params[z], server._make_batch(tokens, cfg), cfg)
    top2 = np.sort(np.asarray(logits[row, pos], np.float32))[-2:]
    return float(top2[1] - top2[0])
