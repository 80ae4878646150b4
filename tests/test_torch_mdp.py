"""Port's MDP model, topology, perf model, workloads and monitor vs the JAX
package's, on the CPU.

Every part here is NumPy or plain Python in the reference, so every number
must match bit for bit: the ``ModelVariant`` of each registered pipeline,
Eq. 1-7 metrics, rewards and feasibility on seeded random configs,
placements and cursors on the built-in clusters, workload traces and the
monitor's load history.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.cluster import monitor as jmonitor  # noqa: E402
from repro.cluster import perf_model as jperf  # noqa: E402
from repro.cluster import workloads as jworkloads  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import mdp as jmdp  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.cluster import monitor, perf_model, workloads  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import mdp  # noqa: E402

PIPELINES = sorted(japi.list_pipelines())
CLUSTERS = sorted(japi.list_clusters())
QUANTS = ("bf16", "int8", "int4")


def as_data(obj):
    """A frozen dataclass tree as plain tuples/dicts, for exact comparison
    across the two packages' (distinct) classes."""
    return dataclasses.asdict(obj)


def pipes(name):
    return japi.get_pipeline(name).build(), api.get_pipeline(name).build()


def random_configs(pipe, n, seed):
    """Seeded configs over (and just past) each knob's range, so infeasible
    and out-of-range ones are among them."""
    rng = np.random.default_rng(seed)
    bc = pipe.batch_choices()
    out = []
    for _ in range(n):
        z = tuple(int(rng.integers(0, len(t.variants))) for t in pipe.tasks)
        f = tuple(int(rng.integers(1, pipe.f_max + 2)) for _ in pipe.tasks)
        b = tuple(int(rng.choice(bc + [pipe.b_max + 1])) for _ in pipe.tasks)
        out.append((z, f, b))
    return out


def test_all_reference_configs_ported():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_arch_config_and_counts_identical(name):
    a, b = JARCHS[name], ARCHS[name]
    assert as_data(a) == as_data(b)
    assert a.param_count() == b.param_count()
    assert a.active_param_count() == b.active_param_count()
    assert as_data(a.smoke()) == as_data(b.smoke())


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_variant_from_arch_bit_for_bit(name, quant):
    assert as_data(jperf.variant_from_arch(JARCHS[name], quant=quant)) == \
        as_data(perf_model.variant_from_arch(ARCHS[name], quant=quant))


def test_perf_model_constants_are_the_references():
    for k in ("PEAK_FLOPS", "HBM_BW", "HBM_CAP", "EFFICIENCY",
              "DISPATCH_OVERHEAD", "TOKENS_PER_REQ"):
        assert getattr(perf_model, k) == getattr(jperf, k), k
    assert (mdp.ADAPTATION_INTERVAL, mdp.COLD_START_FRACTION) == \
        (jmdp.ADAPTATION_INTERVAL, jmdp.COLD_START_FRACTION)


@pytest.mark.parametrize("name", PIPELINES)
def test_registered_pipeline_variants_bit_for_bit(name):
    jp, tp = pipes(name)
    assert as_data(jp) == as_data(tp)
    assert tp.batch_choices() == jp.batch_choices()
    assert tp.scalar_pool == jp.scalar_pool
    assert as_data(tp.topo) == as_data(jp.topo)


def test_default_pipeline_bit_for_bit():
    assert as_data(jperf.default_pipeline()) == as_data(perf_model.default_pipeline())


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", ["paper-4stage", "serve3"])
def test_metrics_reward_feasible_on_random_configs(name, cluster):
    """Eq. 1-7 on 120 seeded configs, on each built-in cluster."""
    jspec = japi.replace(japi.get_pipeline(name), cluster=japi.get_cluster(cluster))
    tspec = api.replace(api.get_pipeline(name), cluster=api.get_cluster(cluster))
    jp, tp = jspec.build(), tspec.build()
    w, jw = mdp.QoSWeights(), jmdp.QoSWeights()
    rng = np.random.default_rng(11)
    for z, f, b in random_configs(jp, 120, seed=len(name) + len(cluster)):
        jc, tc = jmdp.Config(z, f, b), mdp.Config(z, f, b)
        demand = float(rng.uniform(0.5, 160.0))
        cold = float(rng.choice([0.0, 0.1, 0.3]))
        assert mdp.feasible(tp, tc) == jmdp.feasible(jp, jc)
        assert mdp.resources_feasible(tp, tc) == jmdp.resources_feasible(jp, jc)
        assert mdp.resource_usage(tp, tc) == jmdp.resource_usage(jp, jc)
        assert mdp.pipeline_metrics(tp, tc, demand, cold_frac=cold) == \
            jmdp.pipeline_metrics(jp, jc, demand, cold_frac=cold)
        assert mdp.evaluate(tp, tc, demand, w, cold_frac=cold) == \
            jmdp.evaluate(jp, jc, demand, jw, cold_frac=cold)
        assert mdp.reward(tp, tc, demand, w) == jmdp.reward(jp, jc, demand, jw)
        assert mdp.qos(tp, tc, demand, w) == jmdp.qos(jp, jc, demand, jw)
        assert mdp.objective(tp, tc, demand, w) == jmdp.objective(jp, jc, demand, jw)
        assert mdp.accuracy_and_cost(tp, tc) == jmdp.accuracy_and_cost(jp, jc)
        assert mdp.analytic_pipeline_latency(tp, tc, demand) == \
            jmdp.analytic_pipeline_latency(jp, jc, demand)


def test_stage_latency_and_scoring_bit_for_bit():
    rng = np.random.default_rng(5)
    jvar = jperf.variant_from_arch(JARCHS["starcoder2-3b"], quant="int8")
    tvar = perf_model.variant_from_arch(ARCHS["starcoder2-3b"], quant="int8")
    for _ in range(200):
        b, f = int(rng.integers(1, 33)), int(rng.integers(1, 9))
        demand = float(rng.uniform(0.0, 300.0))
        kw = ({} if rng.random() < 0.5 else
              {"speed_sum": float(rng.uniform(0.5, 8.0)),
               "min_speed": float(rng.uniform(0.5, 1.25))})
        assert mdp.stage_latency(tvar, b, f, demand, **kw) == \
            jmdp.stage_latency(jvar, b, f, demand, **kw)
        m = rng.normal(size=5) * 10
        assert mdp.score_measurements(*m, mdp.QoSWeights(), max_batch=b) == \
            jmdp.score_measurements(*m, jmdp.QoSWeights(), max_batch=b)
    assert mdp.Config((1, 0), (2, 3), (4, 8)).as_array().tolist() == \
        jmdp.Config((1, 0), (2, 3), (4, 8)).as_array().tolist()


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_placements_and_cursor_bit_for_bit(cluster):
    jt, tt = japi.get_cluster(cluster).build(), api.get_cluster(cluster).build()
    assert as_data(jt) == as_data(tt) and tt.trivial == jt.trivial
    assert hash(tt) == hash(api.get_cluster(cluster).build())   # lru_cache key
    rng = np.random.default_rng(3)
    for _ in range(150):
        n = int(rng.integers(1, 5))
        res = tuple(float(rng.choice([1, 2, 3, 4, 6, 8])) for _ in range(n))
        reps = tuple(int(rng.integers(1, 9)) for _ in range(n))
        tp, jp = tt.place(res, reps), jt.place(res, reps)
        assert as_data(tp) == as_data(jp) and tp.feasible == jp.feasible
        jc, tc = jt.cursor(), tt.cursor()
        for w, f in zip(res, reps, strict=True):
            reserve = float(rng.choice([0.0, 2.0, 8.0]))
            assert tc.can_place(w, f, reserve=reserve) == jc.can_place(w, f, reserve=reserve)
            assert tc.place(w, f) == jc.place(w, f)
            assert tc.rem == jc.rem and tc.remaining == jc.remaining


@pytest.mark.parametrize("name", ["serve3-hetero", "paper-4stage"])
def test_placement_for_configs_bit_for_bit(name):
    jp, tp = pipes(name)
    for z, f, b in random_configs(jp, 60, seed=9):
        assert as_data(mdp.placement_for(tp, mdp.Config(z, f, b))) == \
            as_data(jmdp.placement_for(jp, jmdp.Config(z, f, b)))


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("kind", list(jworkloads.WORKLOADS))
def test_workload_traces_bit_for_bit(kind, seed):
    assert workloads.WORKLOADS == jworkloads.WORKLOADS
    want = jworkloads.make_trace(kind, seed=seed, seconds=600, peak=90.0)
    got = workloads.make_trace(kind, seed=seed, seconds=600, peak=90.0)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_unknown_workload_raises():
    with pytest.raises(ValueError, match="unknown workload"):
        workloads.make_trace("nope")


def test_monitor_bit_for_bit():
    jm, tm = jmonitor.Monitor(history=16), monitor.Monitor(history=16)
    assert np.array_equal(tm.load_history(), jm.load_history())
    rng = np.random.default_rng(2)
    for i in range(40):
        load = float(rng.uniform(0, 50))
        jm.record(load, qos=float(i))
        tm.record(load, qos=float(i))
        assert tm.valid == jm.valid
        assert np.array_equal(tm.load_history(), jm.load_history())
        assert tm.latest("qos") == jm.latest("qos") and tm.latest("x", 7.0) == 7.0
