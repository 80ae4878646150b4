"""Port's event-driven serving runtime, arrivals, telemetry and MDP envs vs
the JAX package's, on the CPU.

The reference computes all of it in NumPy, ``heapq`` and plain Python, so
the port must reproduce it bit for bit: arrival times, the batch log, the
completions and ``summary()`` of a runtime (with and without a mid-run
``apply_config``/``prewarm``), and the per-step observations, rewards and
infos of ``PipelineEnv`` and ``RuntimeEnv`` under every non-learned
controller. With live smoke-scale executors whose weights are carried
across from the reference, every stage output matches token for token.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api import session as jsession  # noqa: E402
from repro.cluster import env as jenv  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import expert as jexpert  # noqa: E402
from repro.core import mdp as jmdp  # noqa: E402
from repro.serving import arrivals as jarrivals  # noqa: E402
from repro.serving import runtime as jruntime  # noqa: E402
from repro.serving import telemetry as jtelemetry  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.cluster import env  # noqa: E402
from repro_torch.core import baselines, expert, mdp  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402
from repro_torch.serving import arrivals, runtime, telemetry  # noqa: E402

REF = SimpleNamespace(api=japi, mdp=jmdp, runtime=jruntime, arrivals=jarrivals,
                      env=jenv, baselines=jbaselines, expert=jexpert)
PORT = SimpleNamespace(api=api, mdp=mdp, runtime=runtime, arrivals=arrivals,
                       env=env, baselines=baselines, expert=expert)
CONTROLLERS = ("greedy", "capacity", "expert", "ipa", "random")


def make_controller(ns, name, pipe, seed=3):
    return {"greedy": lambda: ns.baselines.GreedyPolicy(pipe),
            "capacity": lambda: ns.expert.CapacityPolicy(pipe),
            "expert": lambda: ns.expert.ExpertPolicy(pipe),
            "ipa": lambda: ns.baselines.IPAPolicy(pipe),
            "random": lambda: ns.baselines.RandomPolicy(pipe, seed=seed)}[name]()


# ------------------------------------------------------------- arrivals --

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scenario", list(jarrivals.SCENARIOS))
def test_arrival_times_bit_for_bit(scenario, seed):
    assert arrivals.SCENARIOS == jarrivals.SCENARIOS
    jp = jarrivals.make_arrivals(scenario, rate=25.0, seed=seed)
    tp = arrivals.make_arrivals(scenario, rate=25.0, seed=seed)
    for horizon in (60, 37.5):
        want, got = jp.times(horizon), tp.times(horizon)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert not got.flags.writeable
    assert np.array_equal(tp.rates(120), jp.rates(120))
    assert tp.to_dict() == jp.to_dict()
    back = arrivals.arrivals_from_dict(jp.to_dict())
    assert np.array_equal(back.generate(60), jp.generate(60))


@pytest.mark.parametrize("name", sorted(japi.list_scenarios()))
def test_scenario_spec_streams_bit_for_bit(name):
    js = japi.replace(japi.get_scenario(name), horizon=60)
    ts = api.replace(api.get_scenario(name), horizon=60)
    assert np.array_equal(ts.build_arrivals().times(60), js.build_arrivals().times(60))
    assert np.array_equal(ts.eval_trace(), js.eval_trace())
    assert np.array_equal(ts.train_trace(2, seconds=300), js.train_trace(2, seconds=300))
    assert np.array_equal(ts.train_arrivals(1).times(30), js.train_arrivals(1).times(30))


def test_unknown_scenario_raises():
    with pytest.raises(ValueError, match="unknown arrival scenario"):
        arrivals.make_arrivals("nope")


# ------------------------------------------------------------ telemetry --

def test_telemetry_queries_bit_for_bit():
    rng = np.random.default_rng(8)
    jt, tt = jtelemetry.Telemetry(), telemetry.Telemetry()
    for i in range(400):
        t = float(rng.uniform(0, 50)) if i % 7 == 0 else i * 0.1   # some out of order
        finish = t + float(rng.uniform(0, 3))
        for tel in (jt, tt):
            tel.record_arrival(t)
            tel.record_completion(i, t, finish)
            if i % 11 == 0:
                tel.record_shed(t)
            tel.record_batch(i % 2, t, 1 + i % 8, 0.01 * i, i % 5)
        if i % 50 == 0:
            jt.record_reconfig(t, 1)
            tt.record_reconfig(t, 1)
    for t0, t1 in ((0, 10), (5.5, 33.3), (-np.inf, np.inf), (40, 41)):
        assert np.array_equal(tt.latencies(t0, t1), jt.latencies(t0, t1))
        assert tt.completed_in(t0, t1) == jt.completed_in(t0, t1)
        assert tt.arrived_in(t0, t1) == jt.arrived_in(t0, t1)
        assert tt.shed_in(t0, t1) == jt.shed_in(t0, t1)
        pt = tt.latency_percentiles(t0=t0, t1=t1)
        pj = jt.latency_percentiles(t0=t0, t1=t1)
        assert pt.keys() == pj.keys()
        assert all(pt[k] == pj[k] or (np.isnan(pt[k]) and np.isnan(pj[k])) for k in pt)
    assert np.array_equal(tt.load_history(45.0, 30), jt.load_history(45.0, 30))
    assert np.array_equal(tt.queue_depths(1), jt.queue_depths(1))
    assert tt.mean_batch_size(0) == jt.mean_batch_size(0)
    kw = dict(stage_busy=[3.0, 4.5], stage_capacity=[50.0, 0.0])
    assert tt.summary(50.0, **kw) == jt.summary(50.0, **kw)
    assert telemetry.Telemetry().summary(1.0)["p50"] is None
    xs = rng.normal(size=37)
    assert telemetry.percentile(xs, 95) == jtelemetry.percentile(xs, 95)
    assert np.isnan(telemetry.percentile([], 50))


# -------------------------------------------------------------- runtime --

# (pipeline, scenario, seed, horizon, initial config, mid-run actions)
RUNTIME_CASES = {
    "serve3-poisson": ("serve3", "poisson", 1, 40, ((0, 0, 0), (2, 2, 2), (4, 4, 4)), ()),
    "serve3-bursty-reconfig": (
        "serve3", "bursty", 3, 60, ((0, 0, 0), (1, 1, 1), (1, 1, 1)),
        ((12.0, "prewarm", (1, 1)), (14.0, "prewarm", (2, 1)),
         (18.0, "apply", ((0, 1, 0), (2, 3, 2), (8, 4, 16))),
         (33.3, "apply", ((1, 1, 1), (1, 2, 1), (2, 32, 1))),
         (41.0, "prewarm", (0, 0)), (46.0, "apply", ((0, 0, 1), (4, 4, 4), (8, 8, 8))))),
    "hetero-ramp-migrations": (
        "serve3-hetero", "ramp", 2, 50, ((1, 0, 1), (2, 2, 2), (4, 4, 4)),
        ((10.0, "apply", ((0, 1, 0), (6, 3, 2), (8, 8, 8))),
         (20.0, "prewarm", (1, 0)), (21.5, "apply", ((0, 0, 0), (1, 8, 4), (16, 2, 4))),
         (35.0, "apply", ((1, 1, 1), (3, 3, 3), (1, 1, 1))))),
    "serve2-trace": ("serve2", "trace", 4, 30, ((1, 1), (1, 1), (8, 8)),
                     ((9.9, "apply", ((0, 0), (3, 2), (32, 1))),)),
}


def drive_runtime(ns, case):
    pipeline, scenario, seed, horizon, cfg0, actions = RUNTIME_CASES[case]
    pipe = ns.api.get_pipeline(pipeline).build()
    rt = ns.runtime.ServingRuntime.from_pipeline(pipe, cfg=ns.mdp.Config(*cfg0))
    n = rt.load(ns.arrivals.make_arrivals(scenario, rate=25.0, seed=seed), horizon)
    log = []
    for t, kind, arg in actions:
        rt.run_until(t)
        if kind == "apply":
            log.append((rt.apply_config(ns.mdp.Config(*arg)), rt.last_migrations))
        else:
            log.append(rt.prewarm(*arg))
    rt.run_until(horizon)
    mid = (rt.now, rt.queue_depths(), rt.utilization(), rt.node_utilization())
    rt.drain()
    return {"submitted": n, "log": log, "mid": mid, "summary": rt.summary(),
            "batches": [dataclasses.astuple(b) for b in rt.telemetry.batches],
            "completions": [dataclasses.astuple(c) for c in rt.telemetry.completions],
            "reconfigs": rt.telemetry.reconfigs,
            "counters": (rt.switch_count, rt.prewarm_count, rt.migration_count,
                         rt.stale_timers_dropped, rt.in_system, rt._loop.events),
            "config": dataclasses.astuple(rt.config),
            "outputs": [(r.rid, [o.tolist() for o in r.stage_outputs])
                        for r in rt.completed]}


@pytest.mark.parametrize("case", list(RUNTIME_CASES))
def test_runtime_summary_and_batch_log_bit_for_bit(case):
    want, got = drive_runtime(REF, case), drive_runtime(PORT, case)
    assert got["batches"], "no batch dispatched"
    for key in want:
        assert got[key] == want[key], key
    assert got["summary"]["served"] == got["submitted"]


def test_event_loop_ties_break_fifo():
    loop = runtime.EventLoop()
    seen = []
    owner = SimpleNamespace(_handle=lambda kind, payload: seen.append(payload))
    for i in range(5):
        loop.push(1.0 if i % 2 else 0.5, owner, "x", i)
    loop.run_until(0.75)
    assert seen == [0, 2, 4] and loop.now == 0.75 and len(loop) == 2
    loop.drain()
    assert seen == [0, 2, 4, 1, 3] and loop.events == 5 and loop.next_time() is None


# ----------------------------------------------------------------- envs --

def rollout_pipeline_env(ns, controller, pipeline, trace_kind, seed):
    from_api = ns.api.get_scenario(trace_kind)
    trace = ns.api.replace(from_api, seed=seed, horizon=300).eval_trace()
    pipe = ns.api.get_pipeline(pipeline).build()
    e = ns.env.PipelineEnv(pipe, trace, seed=seed)
    ctrl = make_controller(ns, controller, pipe)
    steps, done = [e.reset().tolist()], False
    while not done:
        obs = e.observe()
        cfg = ctrl.decide(obs)
        o, r, done, info = e.step(cfg)
        steps.append((dataclasses.astuple(cfg), obs.state.tolist(), obs.current_load,
                      obs.predicted_load, o.tolist(), r, info))
    return steps


def rollout_runtime_env(ns, controller, pipeline, scenario, seed, horizon):
    pipe = ns.api.get_pipeline(pipeline).build()
    e = ns.env.RuntimeEnv(pipe, ns.arrivals.make_arrivals(scenario, rate=25.0, seed=seed),
                          horizon=horizon)
    ctrl = make_controller(ns, controller, pipe)
    steps, done = [e.state_dim], False
    while not done:
        obs = e.observe()
        cfg = ctrl.decide(obs)
        o, r, done, info = e.step(cfg)
        info = {k: v for k, v in info.items() if k != "apply_wall_s"}
        steps.append((dataclasses.astuple(cfg), obs.state.tolist(), obs.current_load,
                      obs.predicted_load, o.tolist(), r, info))
    steps.append(e.drain())
    return steps


def nan_safe(x):
    """NaN percentiles of an empty interval compare equal to each other."""
    if isinstance(x, float) and np.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: nan_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [nan_safe(v) for v in x]
    return x


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("pipeline", ["serve3", "serve3-hetero"])
def test_pipeline_env_steps_bit_for_bit(controller, pipeline):
    want = rollout_pipeline_env(REF, controller, pipeline, "fluctuating", 5)
    got = rollout_pipeline_env(PORT, controller, pipeline, "fluctuating", 5)
    assert len(got) == 31 and nan_safe(got) == nan_safe(want)


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("pipeline", ["serve3", "serve3-hetero"])
def test_runtime_env_steps_bit_for_bit(controller, pipeline):
    want = rollout_runtime_env(REF, controller, pipeline, "bursty", 3, 50)
    got = rollout_runtime_env(PORT, controller, pipeline, "bursty", 3, 50)
    assert len(got) == 7 and nan_safe(got) == nan_safe(want)


def test_envs_refuse_predictor_and_forecaster():
    pipe = api.get_pipeline("serve3").build()
    trace = np.full(100, 10.0)
    with pytest.raises(NotImplementedError, match="item 3"):
        env.PipelineEnv(pipe, trace, predictor=lambda h: 1.0)
    with pytest.raises(NotImplementedError, match="item 9"):
        env.PipelineEnv(pipe, trace, forecaster=lambda h: [1.0])
    with pytest.raises(NotImplementedError, match="item 9"):
        env.RuntimeEnv(pipe, arrivals.PoissonArrivals(5.0), horizon=10,
                       forecaster=lambda h: [1.0])
    e = env.PipelineEnv(pipe, trace, forecast_in_state=True)
    obs = e.observe()
    assert e.state_dim == obs.state.size == pipe.n_tasks * 9
    assert obs.forecasts is None and obs.horizons is None


# ------------------------------------------------- live smoke executors --

LIVE_SEED = 0      # the random controller's seed: it switches every stage's variant
STAGES = {"stage1": (("llama3.2-1b", "starcoder2-3b"),),
          "two-dense": (("llama3.2-1b", "starcoder2-3b"), ("starcoder2-3b", "llama3.2-1b"))}


def exp_specs(ns, stages, horizon, controller="random"):
    return ns.api.ExperimentSpec(
        pipeline=ns.api.PipelineSpec(name="live", stages=STAGES[stages], quants=("bf16",)),
        scenario=ns.api.replace(ns.api.get_scenario("bursty"), seed=3, horizon=horizon),
        controller=ns.api.replace(ns.api.get_controller(controller), seed=LIVE_SEED),
        real=True)


def carried_servers(stages, horizon):
    """The reference's smoke executors and the port's, with the reference's
    weights carried across."""
    import jax
    jexec = jsession.build_executors(exp_specs(REF, stages, horizon))
    sess = api.Session(exp_specs(PORT, stages, horizon), device="cpu", smoke=True)
    for server, je in zip(sess.stage_servers(), jexec, strict=True):
        for model, jp in zip(server.params, je.__self__.params, strict=True):
            load_jax_params(model, jax.tree.map(np.asarray, jp))
    return jexec, sess


def recorded(executors, calls):
    """The executors, each call's (stage, variant) appended to ``calls``."""
    def wrap(i, fn):
        def run(z, tokens):
            calls.append((i, int(z)))
            return fn(z, tokens)
        return run
    return [wrap(i, fn) for i, fn in enumerate(executors)]


@pytest.mark.parametrize("stages,horizon", [("stage1", 30), ("two-dense", 30)])
def test_live_executors_outputs_token_for_token(stages, horizon):
    jexec, sess = carried_servers(stages, horizon)
    outs, calls = [], []
    port_exec = recorded([s.execute for s in sess.stage_servers()], calls)
    for ns, execs in ((REF, jexec), (PORT, port_exec)):
        pipe = ns.api.PipelineSpec(name="live", stages=STAGES[stages],
                                   quants=("bf16",)).build()
        e = ns.env.RuntimeEnv(pipe, ns.arrivals.make_arrivals("bursty", seed=3),
                              horizon=horizon, executors=execs)
        ctrl = ns.baselines.RandomPolicy(pipe, seed=LIVE_SEED)
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
    # every variant of every stage ran live
    assert set(calls) == {(i, z) for i in range(len(STAGES[stages])) for z in (0, 1)}
    for (jrid, jout), (trid, tout) in zip(jo, to, strict=True):
        assert trid == jrid and tout.dtype == np.int32
        assert np.array_equal(tout, jout), f"request {trid}: stage outputs differ"


def test_live_session_matches_virtual_run():
    """Executors never move virtual time: a real run's report equals the
    virtual run's, and both equal the reference's virtual run."""
    _, sess = carried_servers("stage1", 30)
    calls = []
    sess.servers[0].execute = recorded([sess.servers[0].execute], calls)[0]
    real = sess.serve()
    virtual = api.Session(dataclasses.replace(sess.spec, real=False)).serve()
    jvirtual = japi.Session(dataclasses.replace(
        exp_specs(REF, "stage1", 30), real=False)).serve()
    for key in ("rewards", "configs", "summary", "demand", "latency"):
        assert real[key] == virtual[key] == jvirtual[key], key
    assert {z for _, z in calls} == {0, 1}


# ------------------------------------------------------ the flash planner --

@pytest.mark.parametrize("B", range(1, 33))
def test_plan_tiles_takes_every_runtime_batch(B):
    """The runtime dispatches batches of 1..32 prompts of 32 tokens to the
    flash kernel; the planner must cover every position at each size."""
    for H, Hkv, D in ((32, 8, 64), (24, 2, 128)):
        for bf16 in (False, True):
            plan = fa.plan_tiles(B, 32, H, Hkv, D, bf16=bf16)
            assert plan.grid == (B * Hkv, plan.n_tiles, 1)
            assert plan.n_tiles * plan.warpgroups * plan.positions >= 32
            assert (plan.n_tiles - 1) * plan.warpgroups * plan.positions < 32
            assert plan.positions == fa.ROWS // (H // Hkv)
