"""Port's multi-tenant fleet (``serving/fleet.py``, ``TenantSpec``/
``FleetSpec``, the fleet registry, ``FleetSession`` and the launcher's
``--fleet``) vs the JAX package's, on the CPU.

The reference's fleet is NumPy and plain Python on one shared event loop,
so the port must reproduce it bit for bit: spec JSON, a single-tenant
fleet against the standalone runtime, the registered three-tenant fleet's
summary, rewards and sheds, priority shedding under overload, share
arbitration through a NumPy stub forecaster, and the launcher's lines
(wall-clock events/s masked).
"""
import json
import re
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import fleet as jfleet  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import fleet  # noqa: E402

FLEET = "fleet-3tenant-hetero"


def dump(spec) -> str:
    return json.dumps(spec.to_dict(), sort_keys=True)


def fleet_report(report: dict) -> dict:
    """A fleet report without its wall-clock numbers, JSON-normalised."""
    kept = {k: v for k, v in report.items() if k != "serve_wall_s"}
    kept = json.loads(json.dumps(kept, default=int))
    kept["summary"]["fleet"].pop("events_per_s")
    return kept


# ---------------------------------------------------------------- specs --

def test_fleet_spec_json_identical_and_round_trips():
    want, got = japi.get_fleet(FLEET), api.get_fleet(FLEET)
    assert dump(got) == dump(want)
    assert api.FleetSpec.from_dict(json.loads(dump(want))) == got
    assert api.FleetSpec.from_dict(json.loads(json.dumps(got.to_dict()))) == got
    for jt, t in zip(want.tenants, got.tenants, strict=True):
        assert dump(t) == dump(jt) and api.TenantSpec.from_dict(t.to_dict()) == t
    assert got.horizon == want.horizon == 120
    solo = api.TenantSpec(name="x", pipeline=api.get_pipeline("serve2"),
                          scenario=api.get_scenario("ramp"),
                          controller=api.get_controller("capacity"))
    assert api.TenantSpec.from_dict(json.loads(json.dumps(solo.to_dict()))) == solo
    assert solo.to_dict()["slo_p99"] is None and solo.priority == 1


def test_fleet_registry(monkeypatch):
    # the port registers the reference's one built-in fleet; names this test
    # registers leave with it
    monkeypatch.setattr(registry, "_FLEETS", dict(registry._FLEETS))
    assert api.list_fleets() == (FLEET,) and FLEET in japi.list_fleets()
    spec = api.get_fleet(FLEET)
    assert len(spec.tenants) == 3 and spec.cluster.name == "edge-hetero-3"
    with pytest.raises(KeyError, match="unknown fleet"):
        api.get_fleet("no-such-fleet")
    mine = api.register_fleet(api.replace(spec, name="custom-fleet"))
    assert api.get_fleet("custom-fleet") == mine
    api.register_fleet(mine, name="custom-fleet-2")
    assert {"custom-fleet", "custom-fleet-2"} <= set(api.list_fleets())


def test_tenant_pipeline_rebinds_cluster():
    spec, jspec = api.get_fleet(FLEET), japi.get_fleet(FLEET)
    for t, jt in zip(spec.tenants, jspec.tenants, strict=True):
        rebound = spec.tenant_pipeline(t)
        assert rebound.cluster == spec.cluster and rebound.stages == t.pipeline.stages
        assert dump(rebound) == dump(jspec.tenant_pipeline(jt))
        assert t.pipeline.cluster != spec.cluster


# ------------------------------------------------------------ serving --

def single_tenant(ns, horizon=60):
    tenant = ns.TenantSpec(
        name="solo", pipeline=ns.get_pipeline("serve2"),
        scenario=ns.replace(ns.get_scenario("bursty"), seed=3, horizon=horizon),
        controller=ns.get_controller("greedy"))
    return ns.replace(ns.get_fleet(FLEET), name="fleet-solo", tenants=(tenant,),
                      admission_limit=None)


def test_single_tenant_fleet_matches_serving_runtime():
    """A fleet of one tenant is the port's standalone runtime, event for
    event: same rewards and summary, share exactly 1.0, no reallocation."""
    spec = single_tenant(api)
    t = spec.tenants[0]
    solo = api.Session(api.ExperimentSpec(pipeline=spec.tenant_pipeline(t),
                                          scenario=t.scenario, controller=t.controller,
                                          seq_len=spec.seq_len), device="cpu").serve()
    sess = api.FleetSession(spec, device="cpu")
    rep = sess.serve()
    assert rep["rewards"]["solo"] == solo["rewards"]
    ft = rep["summary"]["tenants"]["solo"]
    for key in ("served", "arrived", "shed", "shed_rate", "throughput_rps",
                "latency_mean_s", "p50", "p95", "p99", "mean_batch_size", "reconfigs",
                "migrations"):
        assert ft[key] == solo["summary"][key], key
    assert ft["share"] == 1.0 and sess.fleet.reallocations == 0
    assert ft["shed"] == 0 and ft["arrived"] == ft["served"]
    assert fleet_report(rep) == fleet_report(japi.FleetSession(single_tenant(japi)).serve())


@pytest.mark.parametrize("horizon", [None, 40])
def test_registered_fleet_matches_reference(horizon):
    want = japi.FleetSession.from_spec(japi.get_fleet(FLEET)).serve(horizon=horizon)
    sess = api.FleetSession.from_spec(json.dumps(api.get_fleet(FLEET).to_dict()),
                                      device="cpu")
    got = sess.serve(horizon=horizon)
    assert fleet_report(got) == fleet_report(want)
    assert got["rewards"] == want["rewards"]
    assert got["shed_per_interval"] == want["shed_per_interval"]
    assert len(got["rewards"]["interactive"]) == (horizon or 120) // 10
    assert sess.fleet.reallocations >= 1 and got["summary"]["fleet"]["events_per_s"] > 0
    assert sum(t.share for t in sess.fleet.tenants) <= 1.0


def overloaded(ns, horizon=40):
    spec = ns.get_fleet(FLEET)
    tenants = tuple(ns.replace(t, scenario=ns.replace(t.scenario, rate=120.0,
                                                      horizon=horizon))
                    for t in spec.tenants)
    return ns.replace(spec, tenants=tenants, admission_limit=150.0)


def test_priority_shedding_matches_reference():
    want = japi.FleetSession(overloaded(japi)).serve()
    got = api.FleetSession(overloaded(api), device="cpu").serve()
    assert fleet_report(got) == fleet_report(want)
    s = got["summary"]
    assert s["fleet"]["shed"] > 0 and s["fleet"]["offered"] == (
        s["fleet"]["served"] + s["fleet"]["shed"])
    rates = [t["shed_rate"] for t in sorted(s["tenants"].values(),
                                            key=lambda t: t["priority"])]
    assert rates[0] >= rates[1] >= rates[2] and rates[0] > rates[-1]
    for t in s["tenants"].values():
        assert t["arrived"] == t["served"] + t["shed"]


def test_scale_topology():
    topo = api.get_cluster("edge-hetero-3").build()
    assert fleet.scale_topology(topo, 1.0) is topo
    half, jhalf = (fleet.scale_topology(topo, 0.5),
                   jfleet.scale_topology(japi.get_cluster("edge-hetero-3").build(), 0.5))
    assert half.name == jhalf.name and half.hop_latency == topo.hop_latency
    assert [(n.capacity, n.speed) for n in half.nodes] == [
        (n.capacity, n.speed) for n in jhalf.nodes]


def stub_forecaster(level):
    """A NumPy forecaster whose 10 s horizon predicts ``level`` times the
    recent load: arbitration reads it through ``predicted_load_at``."""
    def fn(hist):
        recent = float(np.mean(np.asarray(hist, dtype=np.float64)[-10:]))
        return np.asarray([recent, level * recent, 1.5 * recent, 2.0 * recent])
    fn.horizons = (5, 10, 20, 60)
    fn.min_history = 0
    return fn


def arbitrate(ns, fleet_mod, forecast=True):
    """Build the registered fleet directly, the interactive tenant with a
    stub forecaster, and record the shares of every interval."""
    spec = ns.get_fleet(FLEET)
    entries = []
    for t in spec.tenants:
        pipe = spec.tenant_pipeline(t).build()
        entries.append({"name": t.name, "pipe": pipe,
                        "arrivals": t.scenario.build_arrivals(),
                        "controller": ns.controller_factory(t.controller.name)(
                            t.controller, pipe, None),
                        "priority": t.priority, "slo_p99": t.slo_p99,
                        "forecaster": (stub_forecaster(3.0)
                                       if forecast and t.name == "interactive" else None)})
    fl = fleet_mod.build_fleet(entries, admission_limit=spec.admission_limit, horizon=60)
    shares = []
    for _ in range(6):
        out = fl.step_interval()
        shares.append(([t.share for t in fl.tenants],
                       {k: (v["reward"], v["shed"], v["processed"]) for k, v in out.items()}))
    fl.drain()
    s = fl.summary()
    s["fleet"].pop("events", None)
    return shares, json.loads(json.dumps(s, default=int)), fl


def test_stub_forecaster_arbitrates_bit_for_bit():
    want, wsum, _ = arbitrate(japi, jfleet)
    got, gsum, fl = arbitrate(api, fleet)
    assert got == want and gsum == wsum
    # the forecast tenant's demand is its 10 s forecast, three times its load
    inter = fl.tenants[0]
    assert inter.env.predicted_load_at(10) == 3.0 * inter.env.predicted_load_at(5)
    # without it the shares follow the last second's load instead
    assert arbitrate(api, fleet, forecast=False)[0] != got


# ------------------------------------------------------------- launcher --

def masked(text: str) -> str:
    return re.sub(r"events \(\d+/s\)", "events (N/s)", text)


@pytest.mark.parametrize("argv", [["--fleet", FLEET],
                                  ["--fleet", FLEET, "--horizon", "30"]],
                         ids=["120s", "30s"])
def test_launcher_fleet_lines_match_reference(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    want = capsys.readouterr().out
    rep = serve.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert masked(got) == masked(want)
    lines = got.splitlines()
    n = int(argv[argv.index("--horizon") + 1]) if "--horizon" in argv else 120
    assert sum(ln.startswith("t=") for ln in lines) == 3 * (n // 10)
    assert sum(ln.startswith("tenant ") for ln in lines) == 3
    assert lines[-1].startswith(f"fleet {FLEET}: 3 tenants")
    assert rep["summary"]["fleet"]["tenants"] == 3
    with pytest.raises(SystemExit):
        serve.main(["--fleet", "no-such-fleet"])
