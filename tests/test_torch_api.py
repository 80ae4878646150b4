"""Port's control-plane API (specs, registry, Session, the launcher's
``--pipeline`` mode) vs the JAX package's, on the CPU.

Specs serialise to the same JSON, the registries hold the same names, and a
``Session.serve()`` report under a non-learned controller equals the
reference's once the wall-clock keys are dropped. The registered ``opd``
controller trains through ``Session.train`` on the session's device and
serves, and so does ``proactive``, the OPD policy inside the forecast-driven
pre-warm wrapper; with the same NumPy stub forecaster and carried policy
weights the three proactive controllers serve as the reference's do.
``debug_checkify`` turns the twins' sanitizer on, as the reference's does.
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

WALL_KEYS = ("decide_wall_s", "serve_wall_s", "decision_times", "decision_time_total")
CONTROLLERS = ("greedy", "capacity", "expert", "ipa", "random")
LEARNED = ("proactive", "proactive-expert", "proactive-capacity")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The OPD networks are tiny: one intra-op thread runs them faster than
    a pool, whose threads would also contend with other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dump(spec) -> str:
    return json.dumps(spec.to_dict(), sort_keys=True)


def virtual(report: dict) -> dict:
    """The report without its wall-clock keys, JSON-normalised (the random
    policy's configs hold NumPy integers on both sides)."""
    kept = {k: v for k, v in report.items() if k not in WALL_KEYS}
    return json.loads(json.dumps(kept, default=int))


# ---------------------------------------------------------------- specs --

def test_registered_names_match_reference():
    assert api.list_pipelines() == japi.list_pipelines()
    assert api.list_scenarios() == japi.list_scenarios()
    assert api.list_controllers() == japi.list_controllers()
    assert api.list_clusters() == japi.list_clusters()


REGISTERED = ([("pipeline", n) for n in japi.list_pipelines()]
              + [("scenario", n) for n in japi.list_scenarios()]
              + [("controller", n) for n in japi.list_controllers()]
              + [("cluster", n) for n in japi.list_clusters()])


@pytest.mark.parametrize("kind,name", REGISTERED, ids=lambda x: str(x))
def test_registered_spec_json_identical(kind, name):
    want = getattr(japi, f"get_{kind}")(name)
    got = getattr(api, f"get_{kind}")(name)
    assert dump(got) == dump(want)
    # the reference's JSON loads unchanged into the port's spec and back
    cls = type(got)
    assert cls.from_dict(json.loads(dump(want))) == got


def test_experiment_spec_json_loads_unchanged():
    jexp = japi.ExperimentSpec(
        pipeline=japi.replace(japi.get_pipeline("serve3"),
                              cluster=japi.get_cluster("edge-constrained")),
        scenario=japi.replace(japi.get_scenario("ramp"), rate=40.0, seed=5),
        controller=japi.replace(japi.get_controller("random"), seed=9),
        backend="analytic", real=True, seq_len=16)
    text = json.dumps(jexp.to_dict())
    exp = api.ExperimentSpec.from_dict(json.loads(text))
    assert json.dumps(exp.to_dict()) == text
    assert api.ExperimentSpec.from_dict(exp.to_dict()) == exp
    p = api.PredictorSpec(name="p", horizons=(5, 60))
    assert json.dumps(p.to_dict()) == json.dumps(
        japi.PredictorSpec(name="p", horizons=(5, 60)).to_dict())
    assert api.PredictorSpec.from_dict(p.to_dict()) == p


# -------------------------------------------------------------- session --

def experiment(ns, controller, backend, *, pipeline="serve3", cluster=None,
               horizon=50, seed=3):
    pipe = ns.get_pipeline(pipeline)
    if cluster:
        pipe = ns.replace(pipe, cluster=ns.get_cluster(cluster))
    return ns.ExperimentSpec(
        pipeline=pipe,
        scenario=ns.replace(ns.get_scenario("bursty"), seed=seed, horizon=horizon),
        controller=ns.replace(ns.get_controller(controller), seed=seed),
        backend=backend)


@pytest.mark.parametrize("backend", ["runtime", "analytic"])
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_session_report_matches_reference(controller, backend):
    want = japi.Session.from_spec(experiment(japi, controller, backend)).serve()
    got = api.Session.from_spec(experiment(api, controller, backend)).serve()
    assert got.keys() == want.keys()
    assert virtual(got) == virtual(want)
    assert len(got["rewards"]) == 5


@pytest.mark.parametrize("controller", ["capacity", "ipa"])
def test_session_on_hetero_cluster_matches_reference(controller):
    kw = dict(pipeline="serve3", cluster="edge-hetero-3", horizon=40)
    want = japi.run_experiment(experiment(japi, controller, "runtime", **kw))
    got = api.run_experiment(experiment(api, controller, "runtime", **kw))
    assert virtual(got) == virtual(want)
    assert "node_utilization" in got["summary"]


def test_session_from_json_reproduces_and_serves_twice():
    exp = experiment(api, "capacity", "runtime", horizon=30)
    sess = api.Session.from_spec(json.dumps(exp.to_dict()))
    first = virtual(sess.serve())
    assert virtual(sess.serve()) == first == virtual(api.Session(exp).report())
    assert first["summary"]["served"] == first["summary"]["submitted"] > 0


# ------------------------------------------------------------- launcher --

LAUNCHES = [["--horizon", "40"],
            ["--policy", "capacity", "--scenario", "ramp", "--horizon", "30", "--seed", "1"],
            ["--policy", "ipa", "--cluster", "edge-hetero-3", "--horizon", "30",
             "--rate", "30"]]


@pytest.mark.parametrize("argv", LAUNCHES, ids=lambda a: "-".join(a[:2]))
def test_launcher_pipeline_lines_match_reference(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--pipeline", *argv])
    jserve.main()
    want = capsys.readouterr().out
    serve.main(["--pipeline", *argv])
    got = capsys.readouterr().out
    assert got == want and got.count("t=") == int(argv[argv.index("--horizon") + 1]) // 10


# ------------------------------------------------------------------ OPD --

def test_session_trains_and_serves_registered_opd():
    """The registered opd (4 episodes, num_envs 4, expert every 2nd) trains
    on the session's device through the vectorized analytic path, serves
    the runtime backend, and a session given the same params through
    ``with_params`` serves the same results."""
    exp = experiment(api, "opd", "runtime", pipeline="serve2", horizon=60)
    sess = api.Session(exp, device="cpu").train()
    tr = sess.trainer
    assert tr._vec_ok and tr.num_envs == 4
    assert tr.history["expert"] == [False, True, False, True]
    assert all(p.device.type == "cpu" for p in tr.params.parameters())
    rep = sess.serve()
    assert rep["external_params"] is False and len(rep["decision_times"]) == 6
    assert rep["summary"]["served"] == rep["summary"]["submitted"] > 0
    plain = japi.Session(experiment(japi, "greedy", "runtime")).serve().keys()
    assert rep.keys() == plain | {"decision_times", "decision_time_total"}
    again = api.Session(exp, device="cpu").with_params(tr.params).serve()
    assert again["external_params"] is True
    assert virtual(again) == {**virtual(rep), "external_params": True}


def test_build_controller_trains_lazily_and_checks_the_device():
    exp = api.replace(experiment(api, "opd", "analytic", pipeline="serve2", horizon=30),
                      controller=api.replace(api.get_controller("opd"), train_episodes=1,
                                             train_seconds=120))
    sess = api.Session(exp, device="cpu")
    pol = sess.build_controller()
    assert sess.trainer is not None and pol.params is sess.trainer.params
    assert len(sess.trainer.history["reward"]) == 1
    with pytest.raises(ValueError, match="session runs on cpu"):
        api.Session(exp, device="cpu").with_params(sess.trainer.params.to("meta")) \
            .build_controller()


def test_launcher_trains_and_serves_opd(capsys, monkeypatch):
    serve.main(["--pipeline", "--policy", "opd", "--device", "cpu", "--horizon", "60"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert sum(ln.startswith("episode ") for ln in lines) == 4
    assert sum(ln.startswith("t=") for ln in lines) == 6 and lines[-1].startswith("served ")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--pipeline", "--policy", "opd", "--horizon", "10"])


# ---------------------------------------------------------- proactive --

def stub_forecaster():
    """A NumPy forecaster (the same in both packages): a burst a minute
    ahead of every interval, large enough that each inner controller would
    configure another variant for it, so every wrapper publishes plans."""
    def fn(hist):
        recent = float(np.mean(np.asarray(hist, dtype=np.float64)[-10:]))
        return np.asarray([recent, recent, 1.6 * recent + 20.0, 60.0 * recent + 40.0])
    fn.horizons = (5, 10, 20, 60)
    fn.min_history = 0
    return fn


def proactive_serve(ns, name, params=None, **kw):
    """A 60 s serve2 runtime serve under ``name`` with the stub forecaster
    attached (greedy decoding for the OPD policy inside ``proactive``)."""
    exp = experiment(ns, name, "runtime", pipeline="serve2", horizon=60)
    exp = ns.replace(exp, controller=ns.replace(exp.controller, greedy=True),
                     scenario=ns.replace(exp.scenario, predictor="lstm-multi"))
    sess = ns.Session(exp, **kw)
    sess._forecaster = stub_forecaster()        # in place of the trained one
    if params is not None:
        sess.with_params(params)
    return sess.serve(), sess.controller


@pytest.mark.parametrize("name", LEARNED)
def test_learned_controllers_registered_but_raise(name):
    """Each proactive controller builds from its registered factory and
    serves as the reference's: the same configs, rewards and pre-warms,
    the same plans published; ``proactive``'s OPD policy decides on its
    carried params' device. (The name dates from when the port refused
    them.)"""
    assert dump(api.get_controller(name)) == dump(japi.get_controller(name))
    jparams = tparams = None
    if name == "proactive":
        from repro.core import policy as jpolicy
        from repro_torch.core import policy
        from repro_torch.models.convert import load_jax_params
        pipe = api.get_pipeline("serve2").build()
        sizes, dim = policy.head_sizes(pipe), pipe.n_tasks * 9
        jparams = jpolicy.init_policy(jax.random.PRNGKey(5), dim, sizes)
        tparams = load_jax_params(policy.Policy(dim, sizes),
                                  jax.tree.map(np.asarray, jparams))
    want, jctrl = proactive_serve(japi, name, jparams)
    got, ctrl = proactive_serve(api, name, tparams, device="cpu")
    assert virtual(got) == virtual(want)
    assert type(ctrl).__name__ == type(jctrl).__name__ == "ProactiveController"
    assert type(ctrl.inner).__name__ == type(jctrl.inner).__name__
    assert ctrl.planned == jctrl.planned > 0 and ctrl.prewarm_plan == jctrl.prewarm_plan
    assert got["summary"]["prewarms"] == want["summary"]["prewarms"] > 0
    if name == "proactive":
        assert ctrl.inner.device.type == "cpu"


def test_training_a_learned_controller_raises():
    """Training raises only on an unknown ``train_backend``: the runtime
    backend trains on the twin (item 8; ``tests/test_torch_runtime_vec.py``
    holds it). ``proactive`` trains exactly as ``opd`` does (the wrapper
    adds only the plan), then serves."""
    exp = experiment(api, "opd", "analytic", pipeline="serve2", horizon=30)
    runtime = api.replace(exp, controller=api.replace(
        exp.controller, train_backend="runtime", train_episodes=1, num_envs=2))
    sess = api.Session(runtime, device="cpu").train()
    assert sess.trainer._vec_runtime is not None
    assert sess.trainer.history["expert"] == [False]
    bad = api.replace(runtime, controller=api.replace(runtime.controller,
                                                      train_backend="quantum"))
    with pytest.raises(ValueError, match="train_backend"):
        api.Session(bad, device="cpu").train()
    assert api.Session(experiment(api, "greedy", "analytic")).train().controller is None
    short = dict(train_episodes=1, train_seconds=120)

    def trained(name):
        e = experiment(api, name, "analytic", pipeline="serve2", horizon=30)
        e = api.replace(e, controller=api.replace(e.controller, **short))
        return api.Session(e, device="cpu").train()

    pro, opd = trained("proactive"), trained("opd")
    assert pro.trainer.history == opd.trainer.history
    assert all(torch.equal(a, b) for a, b in zip(pro.trainer.params.parameters(),
                                                 opd.trainer.params.parameters(),
                                                 strict=True))
    assert type(pro.build_controller()).__name__ == "ProactiveController"
    rep = pro.serve()
    assert len(rep["rewards"]) == 3


# ------------------------------------------------------- not ported yet --


def test_unported_options_raise(monkeypatch):
    # perf_source="calibrated" is ported; with no table named it raises
    # rather than load the reference's CPU-mesh table
    with pytest.raises(KeyError, match="no default table"):
        api.replace(api.get_pipeline("serve2"), perf_source="calibrated").build()
    with pytest.raises(ValueError, match="unknown perf_source"):
        api.replace(api.get_pipeline("serve2"), perf_source="nope").build()
    exp = experiment(api, "greedy", "runtime")
    # debug_checkify is ported: the session runs its twins under the
    # sanitizer, through the constructor and through from_spec alike
    for sess in (api.Session(exp, debug_checkify=True),
                 api.Session.from_spec(json.dumps(exp.to_dict()), debug_checkify=True)):
        assert sess.debug_checkify
        with sess._sanitize_scope():
            assert sanitize.enabled()
        assert not sanitize.enabled()
    # a scenario's forecaster trains on the session's device: asking for the
    # card on a host without one raises, it never falls back to the CPU
    scen = api.replace(exp.scenario, predictor="lstm-multi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        api.Session(api.replace(exp, scenario=scen)).build_forecaster()
    assert api.Session(api.replace(exp, scenario=api.replace(
        scen, predictor="no-such-predictor")), device="cpu")._forecaster is None
    with pytest.raises(KeyError, match="unknown predictor"):
        api.Session(api.replace(exp, scenario=api.replace(
            scen, predictor="no-such-predictor")), device="cpu").build_forecaster()
    with pytest.raises(SystemExit):
        serve.main(["--fleet", "no-such-fleet"])


def test_real_run_of_unported_family_names_the_stage(monkeypatch):
    """serve3's stage 2 (granite-moe, zamba2) has model code now (the name
    is the test's history): a real run builds all three stages, every
    request passes through each of them, and the virtual-time results equal
    those of the same spec with real=False."""
    from repro_torch.serving import engine
    rows = {}
    execute = engine.StageServer.execute

    def counted(self, z, tokens):
        rows[self.name] = rows.get(self.name, 0) + len(tokens)
        return execute(self, z, tokens)

    monkeypatch.setattr(engine.StageServer, "execute", counted)
    exp = api.replace(experiment(api, "greedy", "runtime", pipeline="serve3"), real=True)
    sess = api.Session(exp, device="cpu", smoke=True)
    rep = sess.serve()
    assert [[c.family for c in s.variants] for s in sess.servers] == [
        ["ssm", "audio"], ["dense", "dense"], ["moe", "hybrid"]]
    served = rep["summary"]["served"]
    assert served > 0 and rows == {f"stage{i}": served for i in range(3)}
    want = api.Session(api.replace(exp, real=False)).serve()
    for key in ("summary", "rewards", "configs"):
        assert virtual(rep)[key] == virtual(want)[key], key
    assert len(api.build_executors(exp, device="cpu", smoke=True)) == 3