"""Port's OPD agent (optimiser, residual features, LSTM, policy, predictor,
PPO, OPDTrainer, OPDPolicy) vs the JAX package's, on the CPU.

The reference's parameter pytrees are carried across with
``load_jax_params`` and inputs are made with numpy from seeds. Layers,
log-probs, entropy, values and gradients hold at f32 1e-5, one AdamW step
and the global-norm clip at 1e-6, multi-step training (the predictor's
loop, the expert-only trainer) at 1e-4; the NumPy parts (``compute_gae``,
``make_dataset``, ``head_sizes``, the action <-> config maps) match bit for
bit. Sampled rollouts cannot match (``jax.random`` against torch
generators), so the trainer is held on expert-only episodes, which are
deterministic, and the policies on greedy decisions.

Errors are relative to max(1, max |reference|) over each array. Parameters after an AdamW step
are held at 1e-4, not 1e-5: the step maps a gradient near eps = 1e-8 to
``g / (|g| + eps)``, of order one, so the f32 rounding of such a gradient
(1e-9, summed in another order) moves the parameter by up to a tenth of a
step of lr = 3e-4.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.cluster import PipelineEnv as JPipelineEnv  # noqa: E402
from repro.cluster import make_trace  # noqa: E402
from repro.core import features as jfeatures  # noqa: E402
from repro.core import opd as jopd  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import ppo as jppo  # noqa: E402
from repro.core import predictor as jpredictor  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.cluster import PipelineEnv  # noqa: E402
from repro_torch.core import features, opd, policy, ppo, predictor  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
KEY = jax.random.PRNGKey(5)
PIPELINES = sorted(japi.list_pipelines())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The OPD networks are tiny: one intra-op thread runs them faster than
    a pool, whose threads would also contend with other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(module, jparams):
    return load_jax_params(module, jax.tree.map(np.asarray, jparams))


def named(tree) -> dict:
    """A reference pytree as {dotted port name: numpy array}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path):
            np.asarray(v) for path, v in flat}


def max_err(jtree, module_or_dict) -> float:
    want = named(jtree)
    got = (dict(module_or_dict.named_parameters())
           if isinstance(module_or_dict, torch.nn.Module) else module_or_dict)
    assert sorted(want) == sorted(got)
    return max(err(want[n], got[n]) for n in want)


def arr(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def err(a, b) -> float:
    """Largest error relative to max(1, max |reference|): f32 sums of
    log-probs over a dozen heads, and their gradients, reach tens, where
    1e-5 absolute is below an ulp."""
    a = np.asarray(a)
    return float(np.abs(a - b.detach().numpy()).max() / max(1.0, float(np.abs(a).max())))


def policy_pair(pipe_name="serve2", seed=0, head_scale=30.0):
    """Reference policy params (heads scaled up so the logits are not all
    near zero) and the port's Policy carrying them."""
    pipe = japi.get_pipeline(pipe_name).build()
    sizes = jpolicy.head_sizes(pipe)
    state_dim = pipe.n_tasks * (9 + (0 if pipe.scalar_pool else pipe.topo.n_nodes))
    jp = jpolicy.init_policy(jax.random.PRNGKey(seed), state_dim, sizes)
    jp["heads"] = [{"w": h["w"] * head_scale, "b": h["b"]} for h in jp["heads"]]
    return pipe, jp, port(policy.Policy(state_dim, sizes), jp)


def states_actions(pipe, n, seed=0):
    sizes = jpolicy.head_sizes(pipe)
    state_dim = pipe.n_tasks * (9 + (0 if pipe.scalar_pool else pipe.topo.n_nodes))
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 1.5, (n, state_dim)).astype(np.float32)
    a = np.stack([rng.integers(0, k, n) for k in sizes], 1).astype(np.int32)
    return s, a


# ----------------------------------------------------------------- layers --

def test_resblock_and_res_mlp():
    jp = jnn.init_res_mlp(KEY, 20, 32, 3)
    for blk in jp["blocks"]:                 # non-trivial LayerNorm affine
        blk["ln"]["g"] = jnp.asarray(arr(32, 1) * 0.5 + 1.0)
        blk["ln"]["b"] = jnp.asarray(arr(32, 2) * 0.1)
    tp = port(tnn.ResMLP(20, 32, 3), jp)
    x = arr((4, 20), 3)
    assert err(jnn.res_mlp(jp, jnp.asarray(x)), tnn.res_mlp(tp, torch.from_numpy(x))) < TOL
    h = arr((4, 32), 4, 2.0)
    assert err(jnn.resblock(jp["blocks"][1], jnp.asarray(h)),
               tnn.resblock(tp.blocks[1], torch.from_numpy(h))) < TOL


@pytest.mark.parametrize("in_dim,hidden,T", [(1, 25, 120), (3, 8, 7)])
def test_lstm_scan(in_dim, hidden, T):
    jp = jnn.init_lstm(KEY, in_dim, hidden)
    jp["wx"]["b"] = jnp.asarray(arr(4 * hidden, 6) * 0.3)
    tp = port(tnn.LSTM(in_dim, hidden), jp)
    x = arr((3, T, in_dim), 7)
    jh, (jhT, jcT) = jnn.lstm_scan(jp, jnp.asarray(x))
    th, (thT, tcT) = tnn.lstm_scan(tp, torch.from_numpy(x))
    assert th.shape == (3, T, hidden)
    assert max(err(jh, th), err(jhT, thT), err(jcT, tcT)) < TOL


def test_extract():
    jp = jfeatures.init_features(KEY, 36)
    tp = port(features.init_features(36), jp)
    assert features.FEATURE_DIM == 128 and features.N_BLOCKS == 3
    assert len(tp.blocks) == 3 and tp.proj.w.shape == (36, 128)
    x = arr((5, 36), 8)
    assert err(jfeatures.extract(jp, jnp.asarray(x)),
               features.extract(tp, torch.from_numpy(x))) < TOL


@pytest.mark.parametrize("pipe_name", ["serve2", "paper-4stage", "serve3-hetero"])
def test_apply_policy_and_log_prob_entropy(pipe_name):
    pipe, jp, tp = policy_pair(pipe_name)
    s, a = states_actions(pipe, 6)
    jl, jv = jpolicy.apply_policy(jp, jnp.asarray(s))
    tl, tv = policy.apply_policy(tp, torch.from_numpy(s))
    assert len(jl) == len(tl) == 3 * pipe.n_tasks
    assert max(err(x, y) for x, y in zip(jl, tl, strict=True)) < TOL
    assert err(jv, tv) < TOL
    want = jpolicy.log_prob_entropy(jp, jnp.asarray(s), jnp.asarray(a))
    got = policy.log_prob_entropy(tp, torch.from_numpy(s), torch.from_numpy(a))
    assert max(err(x, y) for x, y in zip(want, got, strict=True)) < TOL


def test_log_prob_entropy_gradients():
    pipe, jp, tp = policy_pair("paper-4stage")
    s, a = states_actions(pipe, 8, seed=1)

    def jloss(p):
        lp, ent, v = jpolicy.log_prob_entropy(p, jnp.asarray(s), jnp.asarray(a))
        return jnp.sum(lp) + 0.3 * jnp.sum(ent) + jnp.sum(v * v)

    jg = jax.grad(jloss)(jp)
    lp, ent, v = policy.log_prob_entropy(tp, torch.from_numpy(s), torch.from_numpy(a))
    loss = torch.sum(lp) + 0.3 * torch.sum(ent) + torch.sum(v * v)
    names = [n for n, _ in tp.named_parameters()]
    tg = dict(zip(names, torch.autograd.grad(loss, list(tp.parameters())), strict=True))
    assert max_err(jg, tg) < TOL


def test_policy_parameters_train_and_serving_layers_do_not():
    _, _, tp = policy_pair()
    assert all(p.requires_grad for p in tp.parameters())
    assert all(p.requires_grad for p in predictor.init_predictor(0, device="cpu").parameters())
    assert not any(p.requires_grad for p in tnn.ResMLP(4, 8, 1).parameters())


@torch.no_grad()
def test_sample_action_greedy_and_sampled():
    pipe, jp, tp = policy_pair("paper-4stage")
    s, _ = states_actions(pipe, 10, seed=2)
    gen = torch.Generator().manual_seed(0)
    for row in s:
        ja, jlogp, jv = jpolicy.sample_action(jp, jnp.asarray(row), KEY, greedy=True)
        ta, tlogp, tv = policy.sample_action(tp, torch.from_numpy(row), None, greedy=True)
        assert np.array_equal(np.asarray(ja), ta.numpy())
        assert abs(float(jlogp) - float(tlogp)) < TOL and abs(float(jv) - float(tv)) < TOL
        a, logp, v = policy.sample_action(tp, torch.from_numpy(row), gen)
        assert all(0 <= int(i) < k for i, k in zip(a, policy.head_sizes(pipe), strict=True))
        lp, _, vv = policy.log_prob_entropy(tp, torch.from_numpy(row)[None], a[None])
        assert abs(float(lp[0]) - float(logp)) < TOL and abs(float(vv[0]) - float(v)) < TOL


@torch.no_grad()
def test_sampling_follows_the_policy_distribution():
    """Gumbel-max over a generator's noise draws each head's categorical:
    over 4000 draws of one state, every head's empirical frequencies are
    within 0.03 of its softmax."""
    pipe, _, tp = policy_pair("serve2", head_scale=100.0)
    s, _ = states_actions(pipe, 1, seed=3)
    logits, _ = policy.apply_policy(tp, torch.from_numpy(s))
    n = 4000
    noise = policy.gumbel_noise(torch.Generator().manual_seed(1),
                                (n, sum(policy.head_sizes(pipe))), "cpu")
    draws, _ = policy.select_actions([lg.expand(n, -1) for lg in logits], noise)
    for h, lg in enumerate(logits):
        probs = torch.softmax(lg[0], -1).numpy()
        freq = np.bincount(draws[:, h].numpy(), minlength=len(probs)) / n
        assert np.abs(freq - probs).max() < 0.03, h


# ---------------------------------------------------------------- optimiser --

def test_adamw_update_and_clip_by_global_norm():
    jp = jnn.init_res_mlp(KEY, 12, 16, 2)
    tp = port(tnn.ResMLP(12, 16, 2), jp)
    names = [n for n, _ in tp.named_parameters()]
    jopt, topt = joptim.adamw_init(jp), optim.adamw_init(tp)
    for step in range(3):                    # bias corrections beyond step 1
        jg = jax.tree.map(lambda p, s=step: jnp.asarray(
            np.random.default_rng(s).standard_normal(p.shape).astype(np.float32) * 3.0), jp)
        tg = {n: torch.from_numpy(np.array(g)) for n, g in named(jg).items()}
        jg, jn = joptim.clip_by_global_norm(jg, 1.5)
        tg, tn = optim.clip_by_global_norm(tg, 1.5)
        assert float(jn) > 1.5 and abs(float(jn) - float(tn)) < 1e-6 * float(jn)
        assert max_err(jg, tg) < 1e-6
        lr = 1e-2 * (step + 1)
        jp, jopt = joptim.adamw_update(jp, jg, jopt, lr=lr)
        tp, topt = optim.adamw_update(tp, tg, topt, lr=lr)
        assert topt["step"] == int(jopt["step"]) == step + 1
        assert max_err(jp, tp) < 1e-6
        assert max_err(jopt["m"], topt["m"]) < 1e-6 and max_err(jopt["v"], topt["v"]) < 1e-6
    assert names == list(topt["m"])


# ---------------------------------------------------------------- predictor --

def test_predict_batch():
    jp = jpredictor.init_predictor(KEY)
    tp = port(predictor.Predictor(), jp)
    hist = np.abs(arr((4, predictor.HISTORY), 9))
    assert (predictor.HISTORY, predictor.HORIZON, predictor.HIDDEN) == (120, 20, 25)
    assert err(jpredictor.predict_batch(jp, jnp.asarray(hist)),
               predictor.predict_batch(tp, torch.from_numpy(hist))) < TOL


def test_make_dataset_bit_for_bit():
    traces = [make_trace(k, seed=s, seconds=260) for s, k in
              enumerate(("steady_low", "fluctuating", "steady_high"))]
    jX, jy = jpredictor.make_dataset(traces, scale=120.0)
    tX, ty = predictor.make_dataset(traces, scale=120.0)
    assert jX.shape == (3 * 120, 120)
    assert np.array_equal(jX, tX) and np.array_equal(jy, ty)
    assert jX.dtype == tX.dtype == np.float32


def test_train_predictor_step_for_step(monkeypatch):
    """Two epochs from carried initial params: same permutations, batches,
    cosine schedule and output-bias start, params within 1e-4 and the
    per-epoch MSE lines equal."""
    traces = [make_trace("fluctuating", seed=s, seconds=300) for s in range(3)]
    jlog, tlog = [], []
    jp = jpredictor.train_predictor(traces, scale=120.0, epochs=2, batch=96, seed=4,
                                    log=jlog.append)
    init = port(predictor.Predictor(), jpredictor.init_predictor(jax.random.PRNGKey(4)))
    monkeypatch.setattr(predictor, "init_predictor", lambda seed, device: init)
    tp = predictor.train_predictor(traces, scale=120.0, epochs=2, batch=96, seed=4,
                                   log=tlog.append, device="cpu")
    assert max_err(jp, tp) < 1e-4
    assert tlog == jlog and len(tlog) == 2


def test_smape_and_predictor_fn():
    jp = jpredictor.init_predictor(KEY)
    tp = port(predictor.Predictor(), jp)
    traces = [make_trace("steady_low", seed=1, seconds=200)]
    assert abs(jpredictor.smape(jp, traces, scale=120.0)
               - predictor.smape(tp, traces, scale=120.0)) < 1e-3
    hist = np.abs(arr(150, 10)) * 40.0
    jfn, tfn = jpredictor.as_predictor_fn(jp, scale=120.0), predictor.as_predictor_fn(tp, scale=120.0)
    assert tfn.min_history == jfn.min_history == 120
    assert abs(jfn(hist) - tfn(hist)) < 1e-4


# ---------------------------------------------------------------------- PPO --

def test_compute_gae_bit_for_bit():
    rng = np.random.default_rng(0)
    for T in (1, 7, 40):
        r = rng.normal(size=T).astype(np.float32)
        v = rng.normal(size=T).astype(np.float32)
        want = jppo.compute_gae(r, v, 0.37, gamma=0.99, lam=0.95)
        got = ppo.compute_gae(r, v, 0.37, gamma=0.99, lam=0.95)
        assert all(np.array_equal(w, g) and w.dtype == g.dtype
                   for w, g in zip(want, got, strict=True))


@pytest.mark.parametrize("with_bc", [False, True])
def test_ppo_minibatch_update(with_bc):
    pipe, jp, tp = policy_pair("paper-4stage", seed=3, head_scale=10.0)
    s, a = states_actions(pipe, 32, seed=4)
    rng = np.random.default_rng(5)
    old_logp = np.array(jpolicy.log_prob_entropy(jp, jnp.asarray(s), jnp.asarray(a))[0]
                          + rng.normal(0, 0.3, 32), np.float32)
    adv = rng.normal(size=32).astype(np.float32)
    ret = rng.normal(size=32).astype(np.float32)
    bc_s, bc_a = states_actions(pipe, 32, seed=6) if with_bc else (s[[0] * 32], a[[0] * 32])
    coef = 0.3 if with_bc else 0.0
    kw = dict(clip_eps=0.2, c1=0.5, c2=0.01, lr=3e-4)
    jopt, topt = joptim.adamw_init(jp), optim.adamw_init(tp)
    for _ in range(2):
        jp, jopt, *jl = jppo.ppo_minibatch_update(
            jp, jopt, *map(jnp.asarray, (s, a, old_logp, adv, ret, bc_s, bc_a)),
            jnp.float32(coef), **kw)
        tp, topt, *tl = ppo.ppo_minibatch_update(
            tp, topt, *map(torch.from_numpy, (s, a, old_logp, adv, ret, bc_s, bc_a)),
            coef, **kw)
        assert max(abs(float(x) - float(y)) for x, y in zip(jl, tl, strict=True)) < TOL
        assert max_err(jopt["m"], topt["m"]) < TOL
        assert max_err(jopt["v"], topt["v"]) < TOL
        assert max_err(jp, tp) < 1e-4


def make_env_fns(pipe_name, seconds):
    jpipe, tpipe = japi.get_pipeline(pipe_name).build(), api.get_pipeline(pipe_name).build()

    def jmake(seed):
        return JPipelineEnv(jpipe, make_trace("fluctuating", seed=seed, seconds=seconds),
                            seed=seed)

    def tmake(seed):
        return PipelineEnv(tpipe, make_trace("fluctuating", seed=seed, seconds=seconds),
                           seed=seed)
    return jpipe, tpipe, jmake, tmake


def test_trainer_expert_only_matches_reference():
    """``expert_freq=1, num_envs=1``: every episode is an expert episode on
    the legacy loop, so the whole run is deterministic given the initial
    params: after 2 episodes on 200 s traces the params, optimiser moments
    and history agree within 1e-4."""
    jpipe, tpipe, jmake, tmake = make_env_fns("serve2", 200)
    cfg = jppo.PPOConfig(expert_freq=1)
    jtr = jppo.OPDTrainer(jpipe, jmake, ppo=cfg, seed=0, num_envs=1)
    ttr = ppo.OPDTrainer(tpipe, tmake, ppo=ppo.PPOConfig(expert_freq=1), seed=0,
                         num_envs=1, device="cpu")
    ttr.params = port(policy.Policy(ttr.params.features.proj.w.shape[0], ttr.sizes),
                      jtr.params)
    ttr.opt = optim.adamw_init(ttr.params)
    for ep in (1, 2):
        jtr.train_episode(ep)
        ttr.train_episode(ep)
    assert max_err(jtr.params, ttr.params) < 1e-4
    assert max_err(jtr.opt["v"], ttr.opt["v"]) < 1e-4 and ttr.opt["step"] == int(jtr.opt["step"])
    assert ttr.history["expert"] == jtr.history["expert"] == [True, True]
    assert ttr.history["reward"] == jtr.history["reward"]
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        assert np.allclose(ttr.history[k], jtr.history[k], rtol=1e-4, atol=1e-4), k
    assert np.array_equal(ttr.expert_states, jtr.expert_states)
    assert np.array_equal(ttr.expert_actions, jtr.expert_actions)


def test_trainer_sampled_episodes_update_params():
    """Legacy (num_envs=1) and vectorized (num_envs=4) on-policy episodes
    and an expert episode: params move, losses are finite, the expert
    memory fills only from the expert episode."""
    _, tpipe, _, tmake = make_env_fns("serve2", 120)
    for n in (1, 4):
        tr = ppo.OPDTrainer(tpipe, tmake, ppo=ppo.PPOConfig(epochs=1, expert_freq=2),
                            seed=0, num_envs=n, device="cpu")
        assert tr._vec_ok == (n > 1)
        before = [p.detach().clone() for p in tr.params.parameters()]
        tr.train_episode(1)
        assert len(tr.expert_states) == 0
        tr.train_episode(2)
        assert tr.history["expert"] == [False, True] and len(tr.expert_states) == 12
        assert sum(float((a - p.detach()).abs().sum()) for a, p in
                   zip(before, tr.params.parameters(), strict=True)) > 0
        assert np.isfinite(tr.history["loss"]).all()


def test_trainer_refuses_the_runtime_twin():
    """The runtime twin is ported (item 8): a ``vec_runtime`` arrivals
    factory selects it, reading horizon and max_wait from the env as the
    reference does (``tests/test_torch_runtime_vec.py`` trains through it)."""
    _, tpipe, _, tmake = make_env_fns("serve2", 120)
    tr = ppo.OPDTrainer(tpipe, tmake, vec_runtime=lambda seed: None, device="cpu")
    assert tr._vec_runtime is not None and tr._tables is not None
    assert tr._rt_horizon == 120 and tr._rt_max_wait == 0.25


# ----------------------------------------------------------- OPD controller --

def test_committed_trained_policy_decides_as_the_reference():
    """The committed 12-episode policy for paper-4stage on edge-hetero-3
    (state_dim 48: per-node features) takes the reference's greedy decisions
    step for step on that pipeline's fluctuating eval episode."""
    with open(ROOT / "experiments" / "opd_policy_edge-hetero-3.pkl", "rb") as f:
        blob = pickle.load(f)
    jparams = blob["params"]
    exp = {ns: ns.ExperimentSpec(
        pipeline=ns.replace(ns.get_pipeline("paper-4stage"),
                            cluster=ns.get_cluster("edge-hetero-3")),
        scenario=ns.replace(ns.get_scenario("fluctuating"), seed=77),
        controller=ns.replace(ns.get_controller("opd"), seed=77),
        backend="analytic") for ns in (japi, api)}
    tpipe = exp[api].pipeline.build()
    tparams = port(policy.Policy(48, policy.head_sizes(tpipe)), jparams)
    want = japi.Session.from_spec(exp[japi]).with_params(jparams).serve()
    got = api.Session(exp[api], device="cpu").with_params(tparams).serve()
    assert len(got["configs"]) == 120 and got["external_params"] is True
    assert got["configs"] == want["configs"]
    assert got["rewards"] == want["rewards"]
    assert len(got["decision_times"]) == 120


def test_opd_policy_warmup_is_untimed_and_decisions_are_greedy():
    pipe, jp, tp = policy_pair("serve2")
    tpipe = api.get_pipeline("serve2").build()
    env = PipelineEnv(tpipe, make_trace("steady_low", seed=1, seconds=100))
    jenv = JPipelineEnv(pipe, make_trace("steady_low", seed=1, seconds=100))
    pol = opd.OPDPolicy(tpipe, tp, device="cpu")
    pol.warmup(env.observe())
    assert pol.decision_times == []
    got = opd.run_episode(env, pol)
    want = jopd.run_episode(jenv, jopd.OPDPolicy(pipe, jp))
    assert np.array_equal(got["reward"], want["reward"])
    assert len(got["decision_times"]) == 10 and got["decision_time_total"] > 0


def test_entry_points_default_to_cuda(monkeypatch):
    """Asking for CUDA without a GPU raises through resolve_device; nothing
    carries on silently on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpipe = api.get_pipeline("serve2").build()
    _, _, _, tmake = make_env_fns("serve2", 120)
    _, _, tp = policy_pair()
    traces = [make_trace("steady_low", seed=0, seconds=200)]
    for call in (lambda: ppo.OPDTrainer(tpipe, tmake),
                 lambda: opd.OPDPolicy(tpipe, tp),
                 lambda: opd.run_episodes_vectorized(tpipe, tp, np.stack(traces)),
                 lambda: predictor.train_predictor(traces, scale=120.0, epochs=1),
                 lambda: policy.init_policy(0, 18, policy.head_sizes(tpipe))):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    with pytest.raises(ValueError, match="requested device"):
        opd.OPDPolicy(tpipe, tp.to("meta"), device="cpu")


# ------------------------------------------------- NumPy action translation --

@pytest.mark.parametrize("name", PIPELINES)
def test_head_sizes_and_action_config_maps_bit_for_bit(name):
    jpipe, tpipe = japi.get_pipeline(name).build(), api.get_pipeline(name).build()
    sizes = policy.head_sizes(tpipe)
    assert sizes == jpolicy.head_sizes(jpipe)
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = np.array([rng.integers(0, 2 * s) for s in sizes], np.int32)
        cfg = policy.action_to_config(tpipe, a)
        jcfg = jpolicy.action_to_config(jpipe, a)
        assert (cfg.z, cfg.f, cfg.b) == (jcfg.z, jcfg.f, jcfg.b)
        back = policy.config_to_action(tpipe, cfg)
        assert np.array_equal(back, jpolicy.config_to_action(jpipe, jcfg))
        assert back.dtype == np.int32
