"""Port's vectorized analytic env (``repro_torch.core.vecenv``) on the CPU.

The ``tests/test_vecenv.py`` equivalences re-run on the port — step,
reward and observation against the port's NumPy ``PipelineEnv`` at that
file's tolerances across every registered pipeline, ``decode_action``
against ``action_to_config``, GAE against the NumPy loop, exact
permutation invariance along the env axis — plus the port against the
reference's JAX ``vecenv`` at f32 tolerance: steps on the same actions, and
greedy ``vec_rollout`` / ``run_episodes_vectorized`` with carried policy
params, whose actions must be equal.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import opd as jopd  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import vecenv as jvecenv  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.cluster import PipelineEnv, make_trace  # noqa: E402
from repro_torch.core import opd, policy, ppo, vecenv  # noqa: E402
from repro_torch.core.mdp import QoSWeights  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402

WEIGHTS = QoSWeights()
PIPELINES = sorted(japi.list_pipelines())
TWIN = ("serve2", "paper-4stage", "serve3-hetero")
METRICS = ("qos", "cost", "latency", "throughput", "excess", "demand")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The OPD networks are tiny: one intra-op thread runs them faster than
    a pool, whose threads would also contend with other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_actions(pipe, rng, n):
    sizes = policy.head_sizes(pipe)
    return [np.array([rng.integers(0, s) for s in sizes], np.int32) for _ in range(n)]


def state_dim(pipe):
    return pipe.n_tasks * (9 + (0 if pipe.scalar_pool else pipe.topo.n_nodes))


def carried_policy(name, seed=0, head_scale=30.0):
    """Reference policy params (heads scaled up so greedy decisions are not
    near-ties of tiny logits) and the port's Policy carrying them."""
    jpipe, tpipe = japi.get_pipeline(name).build(), api.get_pipeline(name).build()
    sizes = jpolicy.head_sizes(jpipe)
    jp = jpolicy.init_policy(jax.random.PRNGKey(seed), state_dim(jpipe), sizes)
    jp["heads"] = [{"w": h["w"] * head_scale, "b": h["b"]} for h in jp["heads"]]
    tp = load_jax_params(policy.Policy(state_dim(tpipe), sizes),
                         jax.tree.map(np.asarray, jp))
    return jpipe, tpipe, jp, tp


def traces(kind, n, seconds, seed0=0):
    return np.stack([make_trace(kind, seed=seed0 + i, seconds=seconds)
                     for i in range(n)]).astype(np.float32)


# --------------------------------------------------- against PipelineEnv --

@pytest.mark.parametrize("name", PIPELINES)
def test_step_reward_obs_match_port_env(name):
    """vecenv.step reproduces the port's PipelineEnv for the same action
    sequence: observation, reward, and every scored metric."""
    pipe = api.get_pipeline(name).build()
    trace = make_trace("fluctuating", seed=3, seconds=150)
    env = PipelineEnv(pipe, trace, seed=0)
    tables = vecenv.tables_from_pipeline(pipe)
    state = vecenv.init_state(tables)
    tr32 = torch.as_tensor(trace, dtype=torch.float32)[None]

    obs_ref = env.reset()
    assert np.allclose(obs_ref, vecenv.observe(tables, state, tr32)[0].numpy(), atol=1e-4)
    rng = np.random.default_rng(0)
    for a in random_actions(pipe, rng, env.n_steps):
        obs_r, r_ref, _, info = env.step(policy.action_to_config(pipe, a))
        state, obs_v, r_vec, m = vecenv.step(tables, state, torch.as_tensor(a)[None],
                                             tr32, WEIGHTS)
        assert np.isclose(r_ref, float(r_vec[0]), rtol=1e-4, atol=5e-2)
        assert np.allclose(obs_r, obs_v[0].numpy(), atol=1e-3)
        assert bool(m["infeasible"][0]) == info["infeasible"]
        for k in METRICS:
            assert np.isclose(info[k], float(m[k][0]), rtol=1e-4, atol=0.05), k


def test_decode_action_matches_action_to_config():
    pipe = api.get_pipeline("paper-4stage").build()
    tables = vecenv.tables_from_pipeline(pipe)
    acts = random_actions(pipe, np.random.default_rng(1), 25)
    z, f, b = vecenv.decode_action(tables, torch.as_tensor(np.stack(acts)))
    for i, a in enumerate(acts):
        cfg = policy.action_to_config(pipe, a)
        assert (tuple(z[i].tolist()), tuple(f[i].tolist()), tuple(b[i].tolist())) == \
            (cfg.z, cfg.f, cfg.b)


# ------------------------------------------------ against the JAX vecenv --

@pytest.mark.parametrize("name", TWIN)
def test_tables_and_steps_match_reference_vecenv(name):
    """Same action sequence through both twins, four envs at once on the
    port's side: observations, rewards and metrics at f32 tolerance,
    the infeasibility flag exact."""
    jpipe, tpipe = japi.get_pipeline(name).build(), api.get_pipeline(name).build()
    jt, tt = jvecenv.tables_from_pipeline(jpipe), vecenv.tables_from_pipeline(tpipe)
    for k in ("accuracy", "cost", "resource", "alpha", "beta", "node_capacity",
              "node_speed"):
        assert np.array_equal(np.asarray(getattr(jt, k)), getattr(tt, k).numpy()), k
    assert tt.n_nodes == jt.n_nodes and tt.hop_latency == float(jt.hop_latency)
    trs = traces("fluctuating", 4, 150, seed0=5)
    rng = np.random.default_rng(2)
    steps = [np.stack(random_actions(tpipe, rng, 4)) for _ in range(15)]
    tstate = vecenv.init_state(tt, 4)
    jstates = [jvecenv.init_state(jt) for _ in range(4)]
    tobs = vecenv.observe(tt, tstate, torch.as_tensor(trs))
    for i in range(4):
        assert np.allclose(np.asarray(jvecenv.observe(jt, jstates[i], jnp.asarray(trs[i]))),
                           tobs[i].numpy(), rtol=1e-5, atol=1e-5)
    # the reference steps one env at a time, the port all four at once
    for acts in steps:
        tstate, tobs, tr, tm = vecenv.step(tt, tstate, torch.as_tensor(acts),
                                           torch.as_tensor(trs), WEIGHTS)
        for i in range(4):
            jstates[i], jobs, jr, jm = jvecenv.step(jt, jstates[i], jnp.asarray(acts[i]),
                                                    jnp.asarray(trs[i]), WEIGHTS)
            assert np.allclose(np.asarray(jobs), tobs[i].numpy(), rtol=1e-5, atol=1e-5)
            assert np.isclose(float(jr), float(tr[i]), rtol=1e-5, atol=1e-4)
            assert bool(jm["infeasible"]) == bool(tm["infeasible"][i])
            for k in METRICS + ("capacity",):
                assert np.isclose(float(jm[k]), float(tm[k][i]), rtol=1e-5, atol=1e-4), k
            assert np.array_equal(np.asarray(jstates[i].z), tstate.z[i].numpy())


@pytest.mark.parametrize("name", TWIN)
def test_greedy_vec_rollout_matches_reference(name):
    jpipe, tpipe, jp, tp = carried_policy(name)
    trs = traces("fluctuating", 3, 200, seed0=1)
    n_steps = 20
    jt, tt = jvecenv.tables_from_pipeline(jpipe), vecenv.tables_from_pipeline(tpipe)
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(0), s))(jnp.arange(3))
    want = jvecenv.vec_rollout(jp, jt, jnp.asarray(trs), keys, n_steps=n_steps,
                               weights=WEIGHTS, greedy=True)
    got = vecenv.vec_rollout(tp, tt, torch.as_tensor(trs), None, n_steps=n_steps,
                             weights=WEIGHTS, greedy=True)
    assert sorted(got) == sorted(want)
    assert np.array_equal(np.asarray(want["actions"]), got["actions"].numpy())
    for k in ("states", "rewards", "values", "logps", "last_value") + METRICS:
        assert np.allclose(np.asarray(want[k]), got[k].numpy(), rtol=1e-5, atol=1e-4), k


@pytest.mark.parametrize("name", TWIN)
def test_run_episodes_vectorized_matches_reference(name):
    jpipe, tpipe, jp, tp = carried_policy(name, seed=1)
    trs = traces("steady_low", 2, 150)
    want = jopd.run_episodes_vectorized(jpipe, jp, trs)
    got = opd.run_episodes_vectorized(tpipe, tp, trs, device="cpu")
    assert sorted(got) == sorted(want)
    assert np.array_equal(want["actions"], got["actions"])
    for k in ("rewards",) + METRICS:
        assert np.allclose(want[k], got[k], rtol=1e-5, atol=1e-4), k


# ------------------------------------------------------------------- GAE --

@pytest.mark.parametrize("seed", range(6))
def test_gae_scan_matches_numpy_loop(seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-5, 5, int(rng.integers(2, 41))).astype(np.float32)
    v = np.linspace(-1.0, 1.0, len(r)).astype(np.float32)
    gamma, lam = rng.uniform(0.5, 1.0, 2)
    adv_np, ret_np = ppo.compute_gae(r, v, 0.5, gamma=gamma, lam=lam)
    adv, ret = vecenv.gae_scan(torch.as_tensor(r), torch.as_tensor(v), 0.5,
                               gamma=gamma, lam=lam)
    assert np.allclose(adv_np, adv.numpy(), atol=1e-4)
    assert np.allclose(ret_np, ret.numpy(), atol=1e-4)


def test_vec_gae_equals_per_env_loop_and_reference():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(3, 17)).astype(np.float32)
    v = rng.normal(size=(3, 17)).astype(np.float32)
    lv = rng.normal(size=3).astype(np.float32)
    adv, ret = vecenv.vec_gae(*map(torch.as_tensor, (r, v, lv)), gamma=0.97, lam=0.9)
    jadv, jret = jvecenv.vec_gae(*map(jnp.asarray, (r, v, lv)), gamma=0.97, lam=0.9)
    assert np.allclose(np.asarray(jadv), adv.numpy(), atol=1e-5)
    assert np.allclose(np.asarray(jret), ret.numpy(), atol=1e-5)
    for i in range(3):
        a_i, r_i = ppo.compute_gae(r[i], v[i], float(lv[i]), gamma=0.97, lam=0.9)
        assert np.allclose(adv[i].numpy(), a_i, atol=1e-4)
        assert np.allclose(ret[i].numpy(), r_i, atol=1e-4)


# ------------------------------------------------------ sampled rollouts --

B, SECONDS = 4, 120


def sampled_setup():
    pipe = api.get_pipeline("serve2").build()
    tables = vecenv.tables_from_pipeline(pipe)
    tp = policy.init_policy(0, state_dim(pipe), policy.head_sizes(pipe), device="cpu")
    return pipe, tables, tp, torch.as_tensor(traces("fluctuating", B, SECONDS))


def gens(seeds):
    return vecenv.env_generators(9, seeds, "cpu")


def test_vec_rollout_shapes_and_finiteness():
    pipe, tables, tp, trs = sampled_setup()
    n_steps = SECONDS // 10
    out = vecenv.vec_rollout(tp, tables, trs, gens(range(B)), n_steps=n_steps,
                             weights=WEIGHTS)
    assert out["states"].shape == (B, n_steps, pipe.n_tasks * 9)
    assert out["actions"].shape == (B, n_steps, len(policy.head_sizes(pipe)))
    assert out["last_value"].shape == (B,)
    for k in ("rewards", "values", "logps", "qos"):
        assert out[k].shape == (B, n_steps)
        assert torch.isfinite(out[k]).all(), k
    # one env alone draws the same noise; its products run at another batch
    # size, so floats agree to rounding
    one = vecenv.rollout(tp, tables, trs[2], gens([2])[0], n_steps=n_steps,
                         weights=WEIGHTS)
    assert torch.equal(one["actions"], out["actions"][2])
    for k in out:
        assert torch.allclose(one[k].float(), out[k][2].float(), rtol=1e-5, atol=1e-5), k


@pytest.mark.parametrize("perm_seed", range(4))
def test_permutation_invariant_along_env_axis(perm_seed):
    """Each env consumes only its own (trace, generator): permuting the env
    axis of the inputs permutes every output exactly."""
    _, tables, tp, trs = sampled_setup()
    n_steps = SECONDS // 10
    out = vecenv.vec_rollout(tp, tables, trs, gens(range(B)), n_steps=n_steps,
                             weights=WEIGHTS)
    perm = np.random.default_rng(perm_seed).permutation(B)
    out_p = vecenv.vec_rollout(tp, tables, trs[perm], gens(perm.tolist()),
                               n_steps=n_steps, weights=WEIGHTS)
    for k in out:
        assert torch.equal(out[k][perm], out_p[k]), k


def test_rollout_rewards_match_port_env():
    """Replaying a sampled vec-rollout's actions through PipelineEnv yields
    the same rewards — the trajectory is a real episode."""
    pipe, tables, tp, trs = sampled_setup()
    n_steps = SECONDS // 10
    out = vecenv.vec_rollout(tp, tables, trs, gens(range(B)), n_steps=n_steps,
                             weights=WEIGHTS)
    for i in range(2):
        env = PipelineEnv(pipe, trs[i].double().numpy(), seed=0)
        env.reset()
        for t in range(n_steps):
            _, r, _, _ = env.step(policy.action_to_config(pipe, out["actions"][i, t].numpy()))
            assert np.isclose(r, float(out["rewards"][i, t]), rtol=1e-4, atol=0.05)


def test_greedy_eval_matches_run_episode():
    """run_episodes_vectorized (greedy) reproduces run_episode driving the
    port's OPDPolicy on the same traces."""
    pipe, _, tp, _ = sampled_setup()
    trs = traces("steady_low", 2, 100)
    batch = opd.run_episodes_vectorized(pipe, tp, trs, device="cpu")
    for i in range(2):
        legacy = opd.run_episode(PipelineEnv(pipe, trs[i], seed=0),
                                 opd.OPDPolicy(pipe, tp, device="cpu"))
        assert np.allclose(batch["rewards"][i], legacy["reward"], rtol=1e-4, atol=0.05)
        assert np.allclose(batch["qos"][i], legacy["qos"], rtol=1e-4, atol=0.05)


# ----------------------------------------------------- session training --

def session_spec():
    return api.ExperimentSpec(
        pipeline=api.get_pipeline("serve2"),
        scenario=api.replace(api.get_scenario("fluctuating"), rate=60.0, seed=4,
                             horizon=100),
        controller=api.replace(api.get_controller("opd"), train_episodes=2,
                               train_seconds=120, num_envs=2),
        backend="analytic")


def test_session_train_bit_for_bit_from_serialized_spec():
    """Session.train with num_envs > 1 is bit-for-bit reproducible from a
    serialized ExperimentSpec."""
    blob = json.dumps(session_spec().to_dict())

    def params_of():
        sess = api.Session.from_spec(blob, device="cpu")
        sess.train()
        assert sess.trainer._vec_ok
        return ([p.detach().clone() for p in sess.trainer.params.parameters()],
                list(sess.trainer.history["reward"]))

    p1, h1 = params_of()
    p2, h2 = params_of()
    assert h1 == h2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2, strict=True))
