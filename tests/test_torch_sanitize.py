"""The port's twin sanitizer (``repro_torch.analysis.sanitize``) against the
reference's documented contract (``repro/analysis/sanitize.py``).

The first eight cases are the reference's ``TestCheckifySanitizer`` cases
under the same names, run against the port: off by default, the env flag,
the scope winning over the env, NaN and out-of-bounds raising, a sanitized
vecenv episode and runtime-twin replay completing and matching the port's
``PipelineEnv`` and ``RuntimeEnv`` on fixed actions at the reference's
tolerances (rtol 1e-4 / atol 0.05 and atol 0.15), and the session toggle.
They are held against the contract, not against the reference's own four
checkify tests, which fail under the installed jax. The rest: integer
division by zero, the index checks of the ops the twins use, a NaN planted
in a latency coefficient (raises sanitized, flows through unsanitized),
nested calls, the twin's CUDA-graph switch, and ``debug_checkify`` training
on both backends with the same results as an unsanitized session.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.cluster import PipelineEnv, RuntimeEnv  # noqa: E402
from repro_torch.cluster.workloads import make_trace  # noqa: E402
from repro_torch.core import runtime_vec as rv  # noqa: E402
from repro_torch.core import vecenv  # noqa: E402
from repro_torch.core.mdp import QoSWeights  # noqa: E402
from repro_torch.core.policy import action_to_config, head_sizes, init_policy  # noqa: E402
from repro_torch.serving import make_arrivals  # noqa: E402

WEIGHTS = QoSWeights()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, so that parallel test workers do not contend
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_override():
    """Every case starts and ends under env control."""
    sanitize.enable(None)
    yield
    sanitize.enable(None)


def _replay_inputs(n_steps=6):
    pipe = api.get_pipeline("serve2").build()
    tables = vecenv.tables_from_pipeline(pipe, device="cpu")
    arrivals = make_arrivals("bursty", rate=20, seed=3)
    rng = np.random.default_rng(0)
    sizes = head_sizes(pipe)
    actions = np.stack([[rng.integers(0, s) for s in sizes]
                        for _ in range(n_steps)]).astype(np.int32)
    return pipe, tables, arrivals, actions


class TestCheckifySanitizer:
    def test_checkify_off_by_default(self, monkeypatch):
        monkeypatch.delenv(sanitize.ENV_FLAG, raising=False)
        assert not sanitize.enabled()

    def test_checkify_env_flag(self, monkeypatch):
        monkeypatch.setenv(sanitize.ENV_FLAG, "1")
        assert sanitize.enabled()
        monkeypatch.setenv(sanitize.ENV_FLAG, "0")
        assert not sanitize.enabled()

    def test_checkify_scope_wins_over_env(self, monkeypatch):
        monkeypatch.setenv(sanitize.ENV_FLAG, "1")
        with sanitize.enabled_scope(False):
            assert not sanitize.enabled()
        assert sanitize.enabled()

    def test_checkify_nan_raises(self):
        @sanitize.checked
        def bad(x):
            return torch.log(x)

        assert torch.isnan(bad(torch.tensor(-1.0)))          # off: silent NaN
        with sanitize.enabled_scope():
            with pytest.raises(sanitize.SanitizerError, match="nan"):
                bad(torch.tensor(-1.0))

    def test_checkify_oob_raises(self):
        @sanitize.checked
        def gather(x, i):
            return x[i]

        with sanitize.enabled_scope():
            with pytest.raises(sanitize.SanitizerError, match="out-of-bounds"):
                gather(torch.arange(4.0), torch.tensor(9, dtype=torch.int32))

    def test_checkify_vecenv_episode_matches_reference(self, monkeypatch):
        """A REPRO_CHECKIFY=1 vecenv episode completes and its rewards match
        the port's PipelineEnv stepping the same action sequence."""
        monkeypatch.setenv(sanitize.ENV_FLAG, "1")
        pipe = api.get_pipeline("serve2").build()
        tables = vecenv.tables_from_pipeline(pipe, device="cpu")
        trace = make_trace("fluctuating", seed=3, seconds=150)
        params = init_policy(0, pipe.n_tasks * 9, head_sizes(pipe), device="cpu")
        gen = torch.Generator()
        gen.manual_seed(7)
        traj = vecenv.rollout(params, tables, torch.as_tensor(trace, dtype=torch.float32),
                              gen, n_steps=15, weights=WEIGHTS)
        env = PipelineEnv(pipe, trace, seed=0)
        for t, action in enumerate(traj["actions"].numpy()):
            _, r_ref, _, _ = env.step(action_to_config(pipe, action))
            assert np.isclose(r_ref, float(traj["rewards"][t]), rtol=0.0001, atol=0.05)

    def test_checkify_runtime_replay_matches_reference(self, monkeypatch):
        """A REPRO_CHECKIFY=1 runtime-twin replay completes and matches the
        port's RuntimeEnv on per-interval reward."""
        monkeypatch.setenv(sanitize.ENV_FLAG, "1")
        pipe, tables, arrivals, actions = _replay_inputs()
        env = RuntimeEnv(pipe, arrivals, horizon=60)
        ref_r = []
        for a in actions:
            _, r, _, _ = env.step(action_to_config(pipe, a))
            ref_r.append(float(r))
        ep = rv.episode_arrivals(make_arrivals("bursty", rate=20, seed=3), 60)
        out = rv.replay(tables, ep, torch.from_numpy(actions), n_steps=6, weights=WEIGHTS)
        assert np.allclose(out["rewards"].numpy(), ref_r, atol=0.15)

    def test_checkify_session_toggle(self):
        spec = api.ExperimentSpec(
            pipeline=api.get_pipeline("serve2"),
            scenario=api.get_scenario("steady_low"),
            controller=api.get_controller("random"),
        )
        sess = api.Session(spec, debug_checkify=True)
        with sess._sanitize_scope():
            assert sanitize.enabled()
        assert not sanitize.enabled()
        off = api.Session(spec)
        with off._sanitize_scope():
            assert not sanitize.enabled()


# ------------------------------------------------------------ the checks --


def test_integer_division_by_zero_raises_and_float_division_does_not():
    @sanitize.checked
    def div(x, y):
        return x // y, torch.remainder(x, y)

    with sanitize.enabled_scope():
        with pytest.raises(sanitize.SanitizerError, match="division by zero"):
            div(torch.tensor([3, 4]), torch.tensor([1, 0]))
        q, r = div(torch.tensor([3, 4]), torch.tensor([2, 3]))
        assert q.tolist() == [1, 1] and r.tolist() == [1, 1]
        # a float division by zero gives inf, which is no NaN
        assert torch.isinf(sanitize.checked(torch.div)(torch.tensor(1.0),
                                                       torch.tensor(0.0)))


@pytest.mark.parametrize("op", ["gather", "index", "index_put", "index_select",
                                "scatter", "embedding", "negative_wraps"])
def test_index_checks_run_before_the_op(op):
    x = torch.arange(8.0).reshape(2, 4)
    bad = torch.tensor([[0, 4]])
    calls = {
        "gather": lambda: torch.gather(x, 1, bad),
        "index": lambda: x[:, torch.tensor([1, 9])],
        "index_put": lambda: x.clone().index_put_((torch.tensor([2]),), torch.tensor(1.0)),
        "index_select": lambda: torch.index_select(x, 1, torch.tensor([4])),
        "scatter": lambda: x.clone().scatter_(1, bad, 1.0),
        "embedding": lambda: torch.nn.functional.embedding(torch.tensor([2]), x),
        "negative_wraps": lambda: x[:, torch.tensor([-5])],
    }
    with sanitize.enabled_scope():
        with pytest.raises(sanitize.SanitizerError, match="out-of-bounds"):
            sanitize.checked(calls[op])()
        # in range (negative indices wrap where torch wraps them): no error
        assert sanitize.checked(lambda: x[:, torch.tensor([-4, 3])])().tolist() == \
            [[0.0, 3.0], [4.0, 7.0]]
        assert sanitize.checked(lambda: torch.gather(x, 1, torch.tensor([[3]])))().item() == 3.0


def test_planted_nan_raises_only_when_sanitized():
    """A NaN in one latency coefficient flows silently into the rewards of
    an unsanitized replay and raises at the op that first produces it in a
    sanitized one."""
    pipe, tables, arrivals, actions = _replay_inputs()
    alpha = tables.alpha.clone()
    alpha[0, 0] = float("nan")
    planted = tables._replace(alpha=alpha)
    ep = rv.episode_arrivals(arrivals, 60)
    out = rv.replay(planted, ep, torch.from_numpy(actions), n_steps=6, weights=WEIGHTS)
    assert torch.isnan(out["rewards"]).any()
    with sanitize.enabled_scope():
        with pytest.raises(sanitize.SanitizerError, match="nan produced by aten"):
            rv.replay(planted, ep, torch.from_numpy(actions), n_steps=6, weights=WEIGHTS)
        clean = rv.replay(tables, ep, torch.from_numpy(actions), n_steps=6, weights=WEIGHTS)
    plain = rv.replay(tables, ep, torch.from_numpy(actions), n_steps=6, weights=WEIGHTS)
    assert all(torch.equal(clean[k], plain[k]) for k in plain)


def test_nested_calls_short_circuit_and_graphs_switch_off():
    seen = []

    @sanitize.checked
    def inner(x):
        seen.append(sanitize._active())
        return x + 1

    @sanitize.checked
    def outer(x):
        return inner(x) * 2

    with sanitize.enabled_scope():
        assert outer(torch.tensor(1.0)).item() == 4.0
        assert seen == [True]               # inner ran under outer's mode
        assert not rv._use_graphs(torch.device("cuda"), None)
        assert not rv._use_graphs(torch.device("cuda"), True)
    assert not sanitize._active()
    assert rv._use_graphs(torch.device("cuda"), None)
    assert not rv._use_graphs(torch.device("cpu"), None)
    assert outer.__wrapped__(torch.tensor(1.0)).item() == 4.0


# ---------------------------------------------------------------- Session --


@pytest.mark.parametrize("backend", ["analytic", "runtime"])
def test_debug_checkify_session_trains_like_an_unsanitized_one(backend):
    """Session(debug_checkify=True) and Session.from_spec(...,
    debug_checkify=True) train the registered opd on either backend without
    raising, to the same history and params as a session without the
    sanitizer (it checks, it does not change the arithmetic), and serve."""
    extra = (dict(train_backend="runtime", num_envs=2) if backend == "runtime"
             else dict(train_seconds=120, num_envs=2))
    spec = api.ExperimentSpec(
        pipeline=api.get_pipeline("serve2"),
        scenario=api.replace(api.get_scenario("bursty"), rate=20.0, seed=4, horizon=20),
        controller=api.replace(api.get_controller("opd"), train_episodes=1, **extra),
        backend="runtime")
    plain = api.Session(spec, device="cpu").train()
    sessions = (api.Session(spec, device="cpu", debug_checkify=True),
                api.Session.from_spec(json.dumps(spec.to_dict()), device="cpu",
                                      debug_checkify=True))
    for sess in sessions:
        sess.train()
        assert sess.trainer.history == plain.trainer.history
        assert all(torch.equal(a, b) for a, b in zip(
            sess.trainer.params.parameters(), plain.trainer.params.parameters(),
            strict=True))
    assert not sanitize.enabled()
    rep = sessions[1].serve()
    assert rep["summary"]["served"] == rep["summary"]["submitted"] > 0
