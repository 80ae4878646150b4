"""Port's discrete-event runtime twin (``repro_torch.core.runtime_vec``) on
the CPU, held against the reference twin (``repro.core.runtime_vec``) and
against the port's NumPy ``RuntimeEnv``/``ServingRuntime`` on the same
arrivals and fixed actions: every case of ``tests/test_runtime_vec.py``
but the closed-loop reward band, which fails in the reference itself
(ROADMAP Queue 3).

Tolerances:
- port twin against the reference twin: equal served counts per interval,
  rewards within 1e-5 of max(1, max |reference|) (f32, the same event
  order, sums over a batch in another order);
- port twin against ``RuntimeEnv``: the reference test's bounds, served
  counts within 2 requests per interval and rewards within 0.15 (the f32
  clock may move a completion across an interval boundary);
- ``episode_arrivals`` / ``stack_episodes``: bit for bit (NumPy);
- permutation along the env axis, the block size between end tests, the
  session's reproducibility: bit for bit;
- greedy rollouts with carried policy weights: equal actions, rewards
  within 1e-5 of max(1, max |reference|).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import runtime_vec as jrv  # noqa: E402
from repro.core import vecenv as jvecenv  # noqa: E402
from repro.core.mdp import QoSWeights as JQoSWeights  # noqa: E402
from repro.serving import make_arrivals as jmake_arrivals  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.cluster import RuntimeEnv  # noqa: E402
from repro_torch.core import OPDTrainer, PPOConfig, policy, vecenv  # noqa: E402
from repro_torch.core import runtime_vec as rv  # noqa: E402
from repro_torch.core.mdp import QoSWeights  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.serving import make_arrivals  # noqa: E402

WEIGHTS = QoSWeights()
HORIZON = 60
N_STEPS = HORIZON // 10
TWIN_TOL = 1e-5
PIPELINES = sorted(japi.list_pipelines())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The twin's tensors are tiny: one intra-op thread runs them faster
    than a pool, whose threads would also contend with other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(want, got) -> float:
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


def random_actions(pipe, rng, n):
    sizes = policy.head_sizes(pipe)
    return np.stack([[rng.integers(0, s) for s in sizes] for _ in range(n)]).astype(np.int32)


def reference_episode(pipe, arrivals, actions):
    """Step the port's event-driven RuntimeEnv through one action sequence."""
    env = RuntimeEnv(pipe, arrivals, horizon=HORIZON)
    rewards, completed = [], []
    for a in actions:
        _, r, _, info = env.step(policy.action_to_config(pipe, a))
        rewards.append(float(r))
        completed.append(int(info["processed"]))
    return np.asarray(rewards), np.asarray(completed)


def both_replays(name, kind, rate, seed, actions):
    """(port twin, reference twin) replays of one action sequence."""
    pipe = api.get_pipeline(name).build()
    out = rv.replay(vecenv.tables_from_pipeline(pipe),
                    rv.episode_arrivals(make_arrivals(kind, rate=rate, seed=seed), HORIZON),
                    torch.from_numpy(actions), n_steps=N_STEPS, weights=WEIGHTS)
    jout = jrv.replay(jvecenv.tables_from_pipeline(japi.get_pipeline(name).build()),
                      jrv.episode_arrivals(jmake_arrivals(kind, rate=rate, seed=seed), HORIZON),
                      jnp.asarray(actions), n_steps=N_STEPS, weights=JQoSWeights())
    return pipe, out, jout


class TestTwinEquivalence:
    """Same arrivals and configuration decisions -> the reference twin's
    served counts and rewards, and ``RuntimeEnv``'s within its bounds, per
    registered pipeline."""

    @pytest.mark.parametrize("name", PIPELINES)
    def test_replay_matches_runtime_env(self, name):
        pipe = api.get_pipeline(name).build()
        actions = random_actions(pipe, np.random.default_rng(0), N_STEPS)
        pipe, out, jout = both_replays(name, "bursty", 20, 3, actions)
        twin_c = out["completed"].numpy().astype(np.int64)
        twin_r = out["rewards"].numpy()
        assert np.array_equal(twin_c, np.asarray(jout["completed"]).astype(np.int64))
        assert rel_err(jout["rewards"], twin_r) < TWIN_TOL
        for key in ("latency", "throughput", "qos", "backlog"):
            assert rel_err(jout[key], out[key].numpy()) < TWIN_TOL, key
        assert np.array_equal(out["queue_depths"].numpy(), np.asarray(jout["queue_depths"]))

        ref_r, ref_c = reference_episode(pipe, make_arrivals("bursty", rate=20, seed=3),
                                         actions)
        assert np.abs(twin_c - ref_c).max() <= 2, (twin_c, ref_c)
        assert twin_c.sum() == pytest.approx(ref_c.sum(), abs=2)
        assert np.allclose(twin_r, ref_r, atol=0.15), (twin_r, ref_r)

    def test_hetero_placement_interval_rewards(self):
        """serve3-hetero pins the placement-aware path: node speeds, hop
        latency, cold starts."""
        pipe = api.get_pipeline("serve3-hetero").build()
        actions = random_actions(pipe, np.random.default_rng(5), N_STEPS)
        pipe, out, jout = both_replays("serve3-hetero", "bursty", 25, 7, actions)
        ref_r, _ = reference_episode(pipe, make_arrivals("bursty", rate=25, seed=7), actions)
        assert np.array_equal(out["completed"].numpy(), np.asarray(jout["completed"]))
        assert rel_err(jout["rewards"], out["rewards"].numpy()) < TWIN_TOL
        assert np.allclose(out["rewards"].numpy(), ref_r, atol=0.15)
        assert int(out["completed"].sum()) > 0

    def test_block_size_between_end_tests_changes_nothing(self, monkeypatch):
        """Envs past ``t_end`` are no-ops, so testing for the interval's end
        every iteration or every ``CHECK_EVERY`` gives the same episode."""
        pipe = api.get_pipeline("serve3-hetero").build()
        actions = torch.from_numpy(random_actions(pipe, np.random.default_rng(1), N_STEPS))
        tables = vecenv.tables_from_pipeline(pipe)
        ep = rv.episode_arrivals(make_arrivals("bursty", rate=25, seed=2), HORIZON)
        outs = []
        for every in (1, rv.CHECK_EVERY):
            monkeypatch.setattr(rv, "CHECK_EVERY", every)
            outs.append(rv.replay(tables, ep, actions, n_steps=N_STEPS, weights=WEIGHTS))
        for k in outs[0]:
            assert torch.equal(outs[0][k], outs[1][k]), k

    def test_capture_needs_a_cuda_device(self):
        tables = vecenv.tables_from_pipeline(api.get_pipeline("serve2").build())
        with pytest.raises(ValueError, match="CUDA"):
            rv.EventLoop(tables, 1, rv.DEFAULT_MAX_WAIT, device="cpu", capture=True)


class TestEpisodeArrivals:
    @pytest.mark.parametrize("kind,rate,seed,n_cap", [
        ("poisson", 12, 1, None), ("bursty", 20, 2, None), ("bursty", 25, 7, 2048)])
    def test_bit_for_bit_with_reference(self, kind, rate, seed, n_cap):
        ep = rv.episode_arrivals(make_arrivals(kind, rate=rate, seed=seed), HORIZON,
                                 n_cap=n_cap)
        jep = jrv.episode_arrivals(jmake_arrivals(kind, rate=rate, seed=seed), HORIZON,
                                   n_cap=n_cap)
        for a, b in zip(ep, jep, strict=True):
            assert a.dtype == torch.float32
            assert np.array_equal(a.numpy(), np.asarray(b))

    def test_times_match_process_and_pad_inf(self):
        arr = make_arrivals("poisson", rate=12, seed=1)
        got = rv.episode_arrivals(arr, HORIZON).times.numpy()
        t = np.asarray(arr.times(HORIZON))
        assert np.array_equal(got[:len(t)], t.astype(np.float32))
        assert np.all(np.isinf(got[len(t):]))
        # the dispatch window needs a guaranteed inf tail
        assert got.shape[0] - len(t) >= rv._ARRIVAL_PAD
        assert got.shape[0] % rv._ARRIVAL_BUCKET == 0

    def test_interval_counts_cover_all_arrivals(self):
        arr = make_arrivals("bursty", rate=20, seed=2)
        ep = rv.episode_arrivals(arr, HORIZON)
        t = np.asarray(arr.times(HORIZON))
        assert ep.arrived.shape == (N_STEPS,)
        assert float(ep.arrived.sum()) == np.count_nonzero(t < HORIZON)

    def test_n_cap_too_small_raises(self):
        with pytest.raises(ValueError):
            rv.episode_arrivals(make_arrivals("bursty", rate=30, seed=0), HORIZON,
                                n_cap=rv._ARRIVAL_PAD)

    def test_stack_pads_to_widest(self):
        eps = [rv.episode_arrivals(make_arrivals("poisson", rate=r, seed=r), HORIZON)
               for r in (5, 40)]
        batch = rv.stack_episodes(eps)
        jbatch = jrv.stack_episodes([
            jrv.episode_arrivals(jmake_arrivals("poisson", rate=r, seed=r), HORIZON)
            for r in (5, 40)])
        assert batch.times.shape == (2, max(e.times.shape[0] for e in eps))
        assert np.all(np.isinf(batch.times[0, eps[0].times.shape[0]:].numpy()))
        for a, b in zip(batch, jbatch, strict=True):
            assert np.array_equal(a.numpy(), np.asarray(b))


class TestVecRollout:
    B = 4

    @pytest.fixture(scope="class")
    def setup(self):
        pipe = api.get_pipeline("serve2").build()
        tables = vecenv.tables_from_pipeline(pipe)
        env = RuntimeEnv(pipe, make_arrivals("bursty", rate=20, seed=0), horizon=HORIZON)
        params = policy.init_policy(0, env.state_dim, policy.head_sizes(pipe), device="cpu")
        eps = rv.stack_episodes([
            rv.episode_arrivals(make_arrivals("bursty", rate=20, seed=i), HORIZON)
            for i in range(self.B)])
        out = rv.vec_rollout(params, tables, eps, vecenv.env_generators(9, range(self.B), "cpu"),
                             n_steps=N_STEPS, weights=WEIGHTS)
        return pipe, tables, params, eps, out

    def test_shapes_and_finiteness(self, setup):
        pipe, _, _, _, out = setup
        assert out["actions"].shape == (self.B, N_STEPS, len(policy.head_sizes(pipe)))
        assert out["last_value"].shape == (self.B,)
        for k in ("rewards", "values", "logps", "qos", "completed"):
            assert out[k].shape == (self.B, N_STEPS)
            assert torch.isfinite(out[k]).all(), k
        assert (out["events"] > 0).all()

    @pytest.mark.parametrize("perm_seed", range(6))
    def test_permutation_invariant_along_env_axis(self, setup, perm_seed):
        """Each env consumes only its own (arrivals, generator): permuting
        the env axis of the inputs permutes every output exactly."""
        _, tables, params, eps, out = setup
        perm = np.random.default_rng(perm_seed).permutation(self.B)
        eps_p = rv.EpisodeArrivals(*(x[torch.from_numpy(perm)] for x in eps))
        out_p = rv.vec_rollout(params, tables, eps_p,
                               vecenv.env_generators(9, perm.tolist(), "cpu"),
                               n_steps=N_STEPS, weights=WEIGHTS)
        for k, v in out.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v[torch.from_numpy(perm)], out_p[k]), k

    def test_rollout_actions_replay_to_same_rewards(self, setup):
        """A vec_rollout trajectory is a real runtime episode: its action
        sequence stepped through RuntimeEnv gives the same rewards."""
        pipe, _, _, _, out = setup
        ref_r, _ = reference_episode(pipe, make_arrivals("bursty", rate=20, seed=0),
                                     out["actions"][0].numpy())
        assert np.allclose(out["rewards"][0].numpy(), ref_r, atol=0.15)

    def test_greedy_rollout_matches_reference_twin(self):
        """With the reference's policy weights carried across, greedy
        rollouts on the two twins take the same actions."""
        name = "serve3-hetero"
        jpipe, pipe = japi.get_pipeline(name).build(), api.get_pipeline(name).build()
        dim = pipe.n_tasks * (9 + pipe.topo.n_nodes)
        jp = jpolicy.init_policy(jax.random.PRNGKey(3), dim, jpolicy.head_sizes(jpipe))
        # heads scaled up so greedy decisions are not near-ties of tiny logits
        jp = dict(jp, heads=[jax.tree.map(lambda x: x * 30.0, h) for h in jp["heads"]])
        tp = load_jax_params(policy.init_policy(0, dim, policy.head_sizes(pipe),
                                                device="cpu"), jax.tree.map(np.asarray, jp))
        seeds = (11, 12)
        eps = rv.stack_episodes([rv.episode_arrivals(
            make_arrivals("bursty", rate=25, seed=s), HORIZON) for s in seeds])
        jeps = jrv.stack_episodes([jrv.episode_arrivals(
            jmake_arrivals("bursty", rate=25, seed=s), HORIZON) for s in seeds])
        out = rv.vec_rollout(tp, vecenv.tables_from_pipeline(pipe), eps, None,
                             n_steps=N_STEPS, weights=WEIGHTS, greedy=True)
        jout = jrv.vec_rollout(jp, jvecenv.tables_from_pipeline(jpipe), jeps,
                               jnp.stack([jax.random.PRNGKey(s) for s in seeds]),
                               n_steps=N_STEPS, weights=JQoSWeights(), greedy=True)
        assert np.array_equal(out["actions"].numpy(), np.asarray(jout["actions"]))
        assert np.array_equal(out["completed"].numpy(), np.asarray(jout["completed"]))
        for k in ("rewards", "values", "logps", "qos", "last_value"):
            assert rel_err(jout[k], out[k].numpy()) < TWIN_TOL, k


class TestTrainerVecRuntime:
    def _factory(self, pipe):
        def arrivals(seed):
            return make_arrivals("bursty", rate=20, seed=seed)

        def make_env(seed):
            return RuntimeEnv(pipe, arrivals(seed), horizon=HORIZON)
        return make_env, arrivals

    def test_vec_runtime_branch_updates_params(self):
        pipe = api.get_pipeline("serve2").build()
        make_env, arrivals = self._factory(pipe)
        tr = OPDTrainer(pipe, make_env, ppo=PPOConfig(epochs=1, expert_freq=2), seed=0,
                        num_envs=4, vec_runtime=arrivals, device="cpu")
        assert tr._vec_runtime is not None
        before = [p.detach().clone() for p in tr.params.parameters()]
        tr.train_episode(1)                     # 1 % 2 != 0 -> runtime twin
        assert tr.history["expert"] == [False]
        delta = sum(float((a - p.detach()).abs().sum())
                    for a, p in zip(before, tr.params.parameters(), strict=True))
        assert delta > 0
        assert np.isfinite(tr.history["loss"]).all()

    def test_expert_episode_steps_real_runtime(self):
        pipe = api.get_pipeline("serve2").build()
        make_env, arrivals = self._factory(pipe)
        tr = OPDTrainer(pipe, make_env, ppo=PPOConfig(epochs=1, expert_freq=1), seed=0,
                        num_envs=4, vec_runtime=arrivals, device="cpu")
        tr.train_episode(1)                     # expert -> legacy RuntimeEnv
        assert tr.history["expert"] == [True]
        assert len(tr.expert_states) > 0


class TestSessionRuntimeBackend:
    def _spec(self, ns=api):
        return ns.ExperimentSpec(
            pipeline=ns.get_pipeline("serve2"),
            scenario=ns.replace(ns.get_scenario("bursty"), rate=20.0, seed=4,
                                horizon=HORIZON),
            controller=ns.replace(ns.get_controller("opd"), train_episodes=2, num_envs=2,
                                  train_backend="runtime"),
            backend="runtime")

    def test_train_backend_roundtrips_through_json(self):
        spec = self._spec()
        blob = json.dumps(spec.to_dict())
        assert blob == json.dumps(self._spec(japi).to_dict())
        back = api.ExperimentSpec.from_dict(json.loads(blob))
        assert back == spec
        assert back.controller.train_backend == "runtime"

    def test_unknown_train_backend_rejected(self):
        spec = api.replace(self._spec(), controller=api.replace(self._spec().controller,
                                                                train_backend="quantum"))
        with pytest.raises(ValueError, match="train_backend"):
            api.Session(spec, device="cpu").train()

    def test_train_reproducible_from_serialized_spec(self):
        """Session.train with train_backend="runtime" is reproducible from a
        serialized ExperimentSpec: every arrival stream and policy draw
        derives from spec seeds."""
        blob = json.dumps(self._spec().to_dict())

        def params_of():
            sess = api.Session.from_spec(blob, device="cpu")
            sess.train()
            return sess.trainer.params, list(sess.trainer.history["reward"])

        (p1, h1), (p2, h2) = params_of(), params_of()
        assert h1 == h2
        assert all(torch.equal(a, b) for a, b in
                   zip(p1.parameters(), p2.parameters(), strict=True))
