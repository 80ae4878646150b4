"""Port's load forecaster, the envs' forecaster hooks and proactive pre-warm
control vs the JAX package's, on the CPU.

Bit for bit (NumPy in both packages): ``make_forecast_dataset`` with one
and three channels, ``telemetry_trace`` of a served runtime, the training
traces and scale ``Session.build_forecaster`` derives from a scenario, the
env hooks (``_forecasts`` and its fallback, ``predicted_load_at``, the Eq. 5
forecast block, ``Observation.forecasts``/``horizons``) and
``ProactiveController``'s plans under a NumPy stub forecaster, and the
predictor and controller registries.

With the reference's weights carried across (``load_jax_params``), inputs
made with numpy from seeds, errors relative to max(1, max |reference|):
``forecast_batch`` of both backbones at 1e-5, one ``_train_step`` at 1e-4
on params and 1e-5 on the loss, a two-epoch ``train_forecaster`` step for
step (params at 1e-4, the per-epoch MSE lines equal), SMAPE and pinball at
1e-3, ``as_forecast_fn`` at 1e-4 of the de-normalised load. Params after an
AdamW step are held at 1e-4 for the reason ``tests/test_torch_opd.py``
gives. A 120 s ``proactive-capacity`` serve of serve2 with the reference's
trained ``lstm-multi`` forecaster carried across gives the reference's
rewards, configs, pre-warm count and summary exactly: no forecast lands
near the pre-warm threshold ``margin x predicted_load`` or a tie of the
capacity policy, so float rounding of the forecasts flips no decision.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api import session as jsession  # noqa: E402
from repro.cluster import env as jenv  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import controller as jcontroller  # noqa: E402
from repro.core import expert as jexpert  # noqa: E402
from repro.core import forecast as jforecast  # noqa: E402
from repro.core import proactive as jproactive  # noqa: E402
from repro.serving import arrivals as jarrivals  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import registry, session  # noqa: E402
from repro_torch.cluster import env  # noqa: E402
from repro_torch.core import baselines, controller, expert, forecast, proactive  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.serving import arrivals  # noqa: E402

REF = SimpleNamespace(api=japi, env=jenv, arrivals=jarrivals, baselines=jbaselines,
                      expert=jexpert, controller=jcontroller, forecast=jforecast,
                      proactive=jproactive)
PORT = SimpleNamespace(api=api, env=env, arrivals=arrivals, baselines=baselines,
                       expert=expert, controller=controller, forecast=forecast,
                       proactive=proactive)
TOL = 1e-5
BACKBONES = ("lstm", "mlstm")
WALL_KEYS = ("decide_wall_s", "serve_wall_s", "decision_times", "decision_time_total")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The forecasters are tiny: one intra-op thread runs them faster than
    a pool, whose threads would also contend with other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(jparams, **kw):
    return load_jax_params(forecast.Forecaster(**kw), jax.tree.map(np.asarray, jparams))


def named(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(k.key) for k in path): np.asarray(v) for path, v in flat}


def err(want, got) -> float:
    want = np.asarray(want, dtype=np.float64)
    got = (got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got))
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


def max_err(jtree, module) -> float:
    want, got = named(jtree), dict(module.named_parameters())
    assert sorted(want) == sorted(got)
    return max(err(want[n], got[n]) for n in want)


def load_traces(n=2, seconds=400, seed=0):
    """Integer per-second loads, as the Monitor feeds the forecaster."""
    t = np.arange(seconds)
    return [np.random.default_rng(seed + i).poisson(
        30.0 + 25.0 * np.sin(2 * np.pi * t / (70.0 + 9 * i)) ** 2).astype(np.float32)
        for i in range(n)]


def telemetry(seconds=400, C=3, seed=0):
    rng = np.random.default_rng(seed)
    tele = rng.uniform(0.0, 40.0, size=(seconds, C)).astype(np.float32)
    tele[:, 0] = load_traces(1, seconds, seed)[0]
    return tele


# -------------------------------------------------------------- dataset --

@pytest.mark.parametrize("channels", [1, 3])
def test_make_forecast_dataset_bit_for_bit(channels):
    traces = ([*load_traces(2)] if channels == 1
              else [telemetry(400, 3, 0), telemetry(350, 3, 1)])
    jX, jy, js = jforecast.make_forecast_dataset(traces, scale=90.0)
    tX, ty, ts = forecast.make_forecast_dataset(traces, scale=90.0)
    assert tX.shape == (400 + (350 if channels == 3 else 400) - 2 * 179, 120, channels)
    for a, b in ((jX, tX), (jy, ty), (js, ts)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    # the returned scales normalise a held-out trace identically
    held = [traces[0][:260]]
    assert all(np.array_equal(a, b) for a, b in zip(
        jforecast.make_forecast_dataset(held, scale=90.0, channel_scales=js),
        forecast.make_forecast_dataset(held, scale=90.0, channel_scales=ts), strict=True))
    assert (forecast.HISTORY, forecast.HORIZONS, forecast.MLSTM_DIM, forecast.MLSTM_HEADS,
            forecast.BACKBONES) == (jforecast.HISTORY, jforecast.HORIZONS,
                                    jforecast.MLSTM_DIM, jforecast.MLSTM_HEADS,
                                    jforecast.BACKBONES)


def test_empty_dataset_and_mixed_channels_raise():
    with pytest.raises(ValueError, match="empty forecast dataset"):
        forecast.train_forecaster([np.ones(150, np.float32)], scale=1.0, device="cpu")
    with pytest.raises(ValueError, match="channel count"):
        forecast.make_forecast_dataset([telemetry(300, 3), telemetry(300, 2)], scale=1.0)


def served_runtime(ns):
    pipe = ns.api.get_pipeline("serve2").build()
    e = ns.env.RuntimeEnv(pipe, ns.arrivals.make_arrivals("bursty", rate=25.0, seed=3),
                          horizon=60)
    ctrl = ns.expert.CapacityPolicy(pipe)
    done = False
    while not done:
        _, _, done, _ = e.step(ctrl.decide(e.observe()))
    return e.runtime


def test_telemetry_trace_bit_for_bit():
    want = jforecast.telemetry_trace(served_runtime(REF))
    got = forecast.telemetry_trace(served_runtime(PORT))
    assert got.shape == (60, 5) and got.dtype == np.float32
    assert np.array_equal(got, want) and got[:, 1:].any()
    assert np.array_equal(forecast.telemetry_trace(served_runtime(PORT), seconds=45),
                          jforecast.telemetry_trace(served_runtime(REF), seconds=45))


# ---------------------------------------------------- carried weights --

@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_forecast_batch(backbone, channels):
    jp = jforecast.init_forecaster(jax.random.PRNGKey(7), backbone=backbone,
                                   in_dim=channels)
    tp = port(jp, backbone=backbone, in_dim=channels)
    assert sorted(named(jp)) == sorted(n for n, _ in tp.named_parameters())
    x = np.abs(np.random.default_rng(channels).standard_normal(
        (6, forecast.HISTORY, channels))).astype(np.float32)
    want = jforecast.forecast_batch(jp, jnp.asarray(x), backbone=backbone)
    with torch.no_grad():
        got = forecast.forecast_batch(tp, torch.from_numpy(x), backbone=backbone)
    assert got.shape == (6, 4) and err(want, got) < TOL


def test_unknown_backbone_raises():
    with pytest.raises(ValueError, match="unknown backbone"):
        forecast.init_forecaster(0, backbone="gru", device="cpu")


@pytest.mark.parametrize("backbone", BACKBONES)
def test_train_step(backbone):
    jp = jforecast.init_forecaster(jax.random.PRNGKey(3), backbone=backbone)
    tp = port(jp, backbone=backbone)
    X, y, _ = jforecast.make_forecast_dataset(load_traces(1), scale=60.0)
    xb, yb = X[:32], y[:32]
    jopt, topt = jforecast.adamw_init(jp), forecast.adamw_init(tp)
    jp, jopt, jl = jforecast._train_step(jp, jopt, jnp.asarray(xb), jnp.asarray(yb),
                                         jnp.float32(3e-3), backbone=backbone, n_heads=2)
    tp, topt, tl = forecast._train_step(tp, topt, torch.from_numpy(xb), torch.from_numpy(yb),
                                        3e-3, backbone=backbone, n_heads=2)
    assert abs(float(jl) - float(tl)) < TOL * max(1.0, abs(float(jl)))
    assert max_err(jp, tp) < 1e-4 and topt["step"] == int(jopt["step"]) == 1


@pytest.mark.parametrize("backbone", BACKBONES)
def test_train_forecaster_step_for_step(backbone, monkeypatch):
    """Two epochs from carried initial params: same permutations, batches,
    cosine schedule and output-bias start, params within 1e-4 and the
    per-epoch MSE lines equal."""
    traces = load_traces(2, seconds=330)
    jlog, tlog = [], []
    jp, js = jforecast.train_forecaster(traces, backbone=backbone, scale=60.0, epochs=2,
                                        batch=96, seed=4, log=jlog.append)
    init = port(jforecast.init_forecaster(jax.random.PRNGKey(4), backbone=backbone),
                backbone=backbone)
    seen = []

    def carried(seed, **kw):
        seen.append((seed, kw))
        return init

    monkeypatch.setattr(forecast, "init_forecaster", carried)
    tp, ts = forecast.train_forecaster(traces, backbone=backbone, scale=60.0, epochs=2,
                                       batch=96, seed=4, log=tlog.append, device="cpu")
    assert seen[0][0] == 4 and seen[0][1]["backbone"] == backbone
    assert max_err(jp, tp) < 1e-4 and np.array_equal(js, ts)
    assert tlog == jlog and len(tlog) == 2
    assert all(p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("backbone", BACKBONES)
def test_smape_pinball_and_forecast_fn(backbone):
    jp = jforecast.init_forecaster(jax.random.PRNGKey(9), backbone=backbone, in_dim=3)
    tp = port(jp, backbone=backbone, in_dim=3)
    held = [telemetry(260, 3, 5)]
    scales = np.asarray([80.0, 40.0, 40.0], np.float32)
    kw = dict(backbone=backbone, scale=80.0, channel_scales=scales)
    for name in ("smape_horizons", "pinball_horizons"):
        want = getattr(jforecast, name)(jp, held, **kw)
        got = getattr(forecast, name)(tp, held, **kw)
        assert list(got) == list(want) == [5, 10, 20, 60]
        assert all(abs(want[h] - got[h]) < 1e-3 for h in want)
    jfn = jforecast.as_forecast_fn(jp, **kw)
    tfn = forecast.as_forecast_fn(tp, **kw)
    assert (tfn.horizons, tfn.min_history, tfn.backbone) == (
        jfn.horizons, jfn.min_history, jfn.backbone) == ((5, 10, 20, 60), 120, backbone)
    for hist in (telemetry(150, 3, 6), telemetry(120, 3, 7)):
        want, got = np.asarray(jfn(hist)), tfn(hist)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.float32
        assert got.shape == (4,) and err(want / 80.0, got / 80.0) < 1e-4


# ------------------------------------------------------- session traces --

@pytest.mark.parametrize("predictor", ["lstm-20s", "lstm-multi", "mlstm-multi"])
def test_build_forecaster_traces_and_scale(predictor, monkeypatch):
    """The training traces (Poisson draws from the scenario's train_trace),
    the scale and every training argument equal the reference's; the
    port's call trains on the session's device, and the forecaster is
    trained once per session."""
    calls = {}

    def spy(tag, ns, backbone):
        def train(traces, **kw):
            calls.setdefault(tag, []).append((traces, kw))
            init = ns.forecast.init_forecaster
            params = (init(jax.random.PRNGKey(0), backbone=backbone, horizons=kw["horizons"])
                      if ns is REF else init(0, backbone=backbone, horizons=kw["horizons"],
                                             device=kw["device"]))
            return params, np.asarray([kw["scale"]], np.float32)
        return train

    backbone = api.get_predictor(predictor).backbone
    monkeypatch.setattr(jforecast, "train_forecaster", spy("ref", REF, backbone))
    monkeypatch.setattr(forecast, "train_forecaster", spy("port", PORT, backbone))

    def session(ns, **kw):
        scen = ns.api.replace(ns.api.get_scenario("bursty"), seed=3, rate=25.0,
                              predictor=predictor)
        exp = ns.api.ExperimentSpec(pipeline=ns.api.get_pipeline("serve2"), scenario=scen,
                                    controller=ns.api.get_controller("greedy"))
        return ns.api.Session(exp, **kw)

    jfn = session(REF).build_forecaster()
    sess = session(PORT, device="cpu")
    tfn = sess.build_forecaster()
    assert sess.build_forecaster() is tfn and len(calls["port"]) == 1
    (jt, jkw), = calls["ref"]
    (tt, tkw), = calls["port"]
    assert len(tt) == len(jt) == 3
    assert all(a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
               for a, b in zip(jt, tt, strict=True))
    assert tkw.pop("device") == "cpu" and tkw.pop("log") is None and jkw.pop("log") is None
    assert tkw == jkw and isinstance(tkw["scale"], float)
    assert (tfn.horizons, tfn.min_history, tfn.backbone) == (
        jfn.horizons, jfn.min_history, jfn.backbone)
    assert session(PORT, device="cpu").spec.scenario.predictor == predictor
    plain = api.replace(sess.spec, scenario=api.replace(sess.spec.scenario, predictor=None))
    assert api.Session(plain).build_forecaster() is None


# ------------------------------------------------------ env hooks (stub) --

def stub(values, horizons=(5, 10, 20, 60), min_history=0):
    """A NumPy forecaster: a fixed function of the history."""
    def fn(hist):
        h = np.asarray(hist, dtype=np.float64).reshape(-1)
        return np.asarray(values, dtype=np.float64) * (1.0 + h[-10:].mean() / 50.0)
    fn.horizons = tuple(horizons)
    fn.min_history = int(min_history)
    return fn


def observed_with_stub(ns, pipeline, min_history, in_state, predictor=None):
    """Nine observations of each env under greedy control. The analytic
    env's 100 s trace leaves its monitor two intervals short of 120 real
    seconds; the runtime env starts with a full monitor."""
    pipe = ns.api.get_pipeline(pipeline).build()
    trace = np.abs(np.sin(np.arange(100) / 9.0)) * 50.0 + 4.0
    fc = stub([11.0, 23.0, 35.0, 71.0], min_history=min_history)
    envs = [ns.env.PipelineEnv(pipe, trace, forecaster=fc, forecast_in_state=in_state,
                               predictor=predictor),
            ns.env.RuntimeEnv(pipe, ns.arrivals.PoissonArrivals(9.0, seed=2), horizon=90,
                              forecaster=fc, forecast_in_state=in_state,
                              predictor=predictor)]
    seen = []
    for e in envs:
        greedy = ns.baselines.GreedyPolicy(pipe)
        seen.append(e.state_dim)
        for _ in range(9):
            o = e.observe()
            seen.append((o.predicted_load, o.current_load, o.state.tolist(), o.forecasts,
                         o.horizons, e._forecasts().tolist(), e.predicted_load_at(5),
                         e.predicted_load_at(10), e.predicted_load_at(100)))
            e.step(greedy(e))
    return seen


@pytest.mark.parametrize("pipeline", ["serve3", "serve3-hetero"])
@pytest.mark.parametrize("in_state", [False, True])
@pytest.mark.parametrize("min_history", [0, 120, 125])
def test_env_forecaster_hooks_bit_for_bit(pipeline, in_state, min_history):
    got = observed_with_stub(PORT, pipeline, min_history, in_state)
    assert got == observed_with_stub(REF, pipeline, min_history, in_state)
    n_tasks = api.get_pipeline(pipeline).build().n_tasks
    dims = [x for x in got if isinstance(x, int)]
    rows = [x for x in got if not isinstance(x, int)]
    base = env.PipelineEnv(api.get_pipeline(pipeline).build(), np.ones(300)).state_dim
    assert dims == [base + (n_tasks * 4 if in_state else 0)] * 2
    assert all(r[3] == tuple(r[5]) and r[4] == (5, 10, 20, 60) for r in rows)
    # fewer real seconds than min_history: every horizon falls back to the
    # current load, and so does the horizon-matched predicted load
    cold = [r[5] == [r[1]] * 4 and r[0] == r[1] == r[7] for r in rows]
    assert cold == {0: [False] * 18, 120: [True] * 2 + [False] * 16,
                    125: [True] * 18}[min_history]
    warm = rows[5]
    assert (warm[6], warm[7], warm[8]) == (warm[5][0], warm[5][1], warm[5][3]) \
        or min_history == 125
    if in_state:
        block = np.asarray(warm[2], np.float32).reshape(n_tasks, -1)[:, -4:]
        assert np.array_equal(block, np.tile(np.float32(np.asarray(warm[5]) / 100.0),
                                             (n_tasks, 1)))


def test_predictor_keeps_eq5_load_beside_forecaster():
    """A single-horizon predictor still feeds predicted_load when a
    forecaster is attached too, as in the reference."""
    def predictor(hist):
        return float(np.max(hist[-30:])) * 1.25 + 0.5
    got = observed_with_stub(PORT, "serve3", 0, True, predictor)
    assert got == observed_with_stub(REF, "serve3", 0, True, predictor)


def proactive_plans(ns, inner):
    """Plans of the wrapper around ``inner`` over random observations, every
    fifth without forecasts."""
    pipe = ns.api.get_pipeline("paper-4stage").build()
    pol = ns.proactive.ProactiveController(
        {"capacity": ns.expert.CapacityPolicy, "expert": ns.expert.ExpertPolicy,
         "greedy": ns.baselines.GreedyPolicy}[inner](pipe))
    live = ns.env.PipelineEnv(pipe, np.ones(60)).cfg
    out = []
    rng = np.random.default_rng(1)
    for k in range(12):
        load = float(rng.uniform(10.0, 80.0))
        fc = None if k % 5 == 4 else tuple(float(v) for v in load * rng.uniform(0.8, 2.5, 4))
        obs = ns.controller.Observation(
            state=rng.uniform(0.0, 1.0, pipe.n_tasks * 9).astype(np.float32),
            config=live, current_load=load, predicted_load=load, forecasts=fc,
            horizons=None if fc is None else (5, 10, 20, 60))
        cfg = pol.decide(obs)
        out.append((dataclasses.astuple(cfg), list(pol.prewarm_plan), pol.planned))
    return out


@pytest.mark.parametrize("inner", ["capacity", "expert", "greedy"])
def test_proactive_controller_plans_bit_for_bit(inner):
    got = proactive_plans(PORT, inner)
    assert got == proactive_plans(REF, inner)
    # greedy's variants stay pinned, so its burst configuration never differs
    assert any(plan for _, plan, _ in got) == (inner != "greedy")
    assert all(plan == [] for k, (_, plan, _) in enumerate(got) if k % 5 == 4)
    pol = proactive.ProactiveController(expert.CapacityPolicy(
        api.get_pipeline("serve2").build()))
    assert (pol.margin, proactive._M_COL, pol.planned, pol.prewarm_plan) == (1.15, 2, 0, [])


# ------------------------------------------------ proactive serve, carried --

@pytest.fixture(scope="module")
def reference_proactive_serve():
    """The reference's 120 s proactive-capacity serve of serve2 with its own
    trained lstm-multi forecaster, and that forecaster's params."""
    trained = {}
    orig = jforecast.train_forecaster

    def keep(traces, **kw):
        trained["params"], trained["scales"] = orig(traces, **kw)
        trained["scale"] = kw["scale"]
        return trained["params"], trained["scales"]

    jforecast.train_forecaster = keep
    try:
        rep = japi.Session.from_spec(proactive_experiment(japi)).serve()
    finally:
        jforecast.train_forecaster = orig
    return rep, trained


def proactive_experiment(ns, predictor="lstm-multi", controller="proactive-capacity"):
    return ns.ExperimentSpec(
        pipeline=ns.get_pipeline("serve2"),
        scenario=ns.replace(ns.get_scenario("bursty"), seed=3, rate=25.0, horizon=120,
                            predictor=predictor),
        controller=ns.replace(ns.get_controller(controller), seed=3),
        backend="runtime")


def virtual(report: dict) -> dict:
    kept = {k: v for k, v in report.items() if k not in WALL_KEYS}
    return json.loads(json.dumps(kept, default=int))


def test_proactive_capacity_serve_with_carried_forecaster(reference_proactive_serve):
    want, trained = reference_proactive_serve
    sess = api.Session(proactive_experiment(api), device="cpu")
    params = port(trained["params"], backbone="lstm")
    sess._forecaster = forecast.as_forecast_fn(
        params, scale=trained["scale"], backbone="lstm", channel_scales=trained["scales"])
    got = sess.serve()
    assert virtual(got) == virtual(want)
    assert got["summary"]["prewarms"] == want["summary"]["prewarms"] > 0
    assert sess.controller.planned > 0
    assert got["summary"]["served"] == got["summary"]["submitted"] > 0


def test_proactive_serve_on_analytic_backend_matches_reference(reference_proactive_serve):
    """The same forecaster on the analytic env (the plan is a no-op there)."""
    _, trained = reference_proactive_serve
    exp_j = japi.replace(proactive_experiment(japi), backend="analytic")
    exp_t = api.replace(proactive_experiment(api), backend="analytic")
    jsess = japi.Session(exp_j)
    jsess._forecaster = jforecast.as_forecast_fn(
        trained["params"], scale=trained["scale"], channel_scales=trained["scales"])
    tsess = api.Session(exp_t, device="cpu")
    tsess._forecaster = forecast.as_forecast_fn(
        port(trained["params"], backbone="lstm"), scale=trained["scale"],
        channel_scales=trained["scales"])
    assert virtual(tsess.serve()) == virtual(jsess.serve())


# ------------------------------------------------------------ registries --

def dump(spec) -> str:
    return json.dumps(spec.to_dict(), sort_keys=True)


def test_predictor_registry_matches_reference(monkeypatch):
    monkeypatch.setattr(registry, "_PREDICTORS", dict(registry._PREDICTORS))
    builtin = ("lstm-20s", "lstm-multi", "mlstm-multi")
    assert api.list_predictors() == builtin
    assert set(builtin) <= set(japi.list_predictors())
    for name in api.list_predictors():
        assert dump(api.get_predictor(name)) == dump(japi.get_predictor(name))
        assert api.PredictorSpec.from_dict(json.loads(dump(japi.get_predictor(name)))) \
            == api.get_predictor(name)
    with pytest.raises(KeyError, match="unknown predictor"):
        api.get_predictor("nope")
    mine = api.register_predictor(api.PredictorSpec(name="mine", backbone="mlstm"))
    assert api.get_predictor("mine") is mine
    api.register_predictor(mine, name="mine-too")
    assert "mine-too" in api.list_predictors()


@pytest.mark.parametrize("name", ["proactive", "proactive-expert", "proactive-capacity"])
def test_proactive_controllers_registered_as_reference(name):
    assert dump(api.get_controller(name)) == dump(japi.get_controller(name))
    assert (name in session._TRAINABLE) == (name in jsession._TRAINABLE) == (
        name == "proactive")
