"""Port's control-plane API (specs, registry, Session, the launcher's
``--pipeline`` mode) vs the JAX package's, on the CPU.

Specs serialise to the same JSON, the registries hold the same names, and a
``Session.serve()`` report under a non-learned controller equals the
reference's once the wall-clock keys are dropped. The registered ``opd``
controller trains through ``Session.train`` on the session's device and
serves; parts the port does not have yet raise ``NotImplementedError``
naming their ROADMAP item.
"""
import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import api  # noqa: E402
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


# ------------------------------------------------------- not ported yet --

@pytest.mark.parametrize("name", LEARNED)
def test_learned_controllers_registered_but_raise(name):
    assert dump(api.get_controller(name)) == dump(japi.get_controller(name))
    sess = api.Session(experiment(api, name, "runtime"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        sess.build_controller()


def test_training_a_learned_controller_raises():
    """What training cannot do yet: the runtime twin (item 8) and the
    proactive wrapper (item 9)."""
    exp = experiment(api, "opd", "analytic")
    runtime = api.replace(exp, controller=api.replace(exp.controller,
                                                      train_backend="runtime"))
    with pytest.raises(NotImplementedError, match="item 8"):
        api.Session(runtime, device="cpu").train()
    with pytest.raises(NotImplementedError, match="item 9"):
        api.Session(experiment(api, "proactive", "analytic"), device="cpu").train()
    assert api.Session(experiment(api, "greedy", "analytic")).train().controller is None


def test_unported_options_raise():
    # perf_source="calibrated" is ported; with no table named it raises
    # rather than load the reference's CPU-mesh table
    with pytest.raises(KeyError, match="no default table"):
        api.replace(api.get_pipeline("serve2"), perf_source="calibrated").build()
    with pytest.raises(ValueError, match="unknown perf_source"):
        api.replace(api.get_pipeline("serve2"), perf_source="nope").build()
    exp = experiment(api, "greedy", "runtime")
    with pytest.raises(NotImplementedError, match="item 13"):
        api.Session(exp, debug_checkify=True)
    scen = api.replace(exp.scenario, predictor="lstm-multi")
    with pytest.raises(NotImplementedError, match="item 9"):
        api.Session(api.replace(exp, scenario=scen)).serve()
    with pytest.raises(NotImplementedError, match="item 10"):
        serve.main(["--fleet", "fleet-3tenant-hetero"])


def test_real_run_of_unported_family_names_the_stage():
    """serve3's stage 2 (granite-moe, zamba2) has no model code yet: a real
    run raises before building anything, naming the stage and item 11 part
    B. serve2's families (audio, ssm) are ported and build."""
    exp = api.replace(experiment(api, "greedy", "runtime", pipeline="serve3"), real=True)
    sess = api.Session(exp, device="cpu", smoke=True)
    with pytest.raises(NotImplementedError,
                       match=r"stage 2: arch 'granite-moe-3b-a800m' .*item 11 part B"):
        sess.serve()
    assert sess.servers is None
    with pytest.raises(NotImplementedError, match="stage 2"):
        api.build_executors(exp, device="cpu", smoke=True)
    serve2 = api.replace(experiment(api, "greedy", "runtime", pipeline="serve2"), real=True)
    servers = api.build_servers(serve2, device="cpu", smoke=True)
    assert [[c.family for c in s.variants] for s in servers] == [["audio", "ssm"],
                                                                  ["dense", "dense"]]
