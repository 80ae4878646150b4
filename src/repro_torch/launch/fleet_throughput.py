"""Multi-tenant fleet serving throughput (the counterpart of the reference's
``benchmarks/fleet_throughput.py``: same spec, rows and payload keys, plus
the payload's device block): the registered 3-tenant fleet on the
heterogeneous edge cell, every tenant's arrival rate raised to drive 1e5
(quick) to about 1e6 requests through the shared event loop. Reports
per-tenant p50/p95/p99 and shed rate, the fleet-wide shed rate, and the
event loop's wall-clock processing rate (events/s).

    PYTHONPATH=src python -m repro_torch.launch.fleet_throughput [--quick] \
        [--device cpu] [--out DIR]

``inv_p99`` (1/p99 seconds, higher is better) is emitted per tenant so a
ratio gate (``benchmarks/gate.py --min-ratio``) guards tail latency with
the same arithmetic as the throughput metrics. The fleet's tenants are
greedy and IPA, host NumPy in virtual time, so ``device`` only names where
the run was taken. Every field but ``wall_s`` and ``events_per_s`` equals
the reference's.
"""
from __future__ import annotations

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results

# per-tenant arrival rates (req/s) sized so the quick run offers >1e5
# requests over its horizon while the cluster, fully allocated, can still
# serve the large majority (shed stays a reported tail, not the bulk)
QUICK_RATES = {"interactive": 400.0, "analytics": 300.0, "batch": 250.0}
QUICK_HORIZON = 120
FULL_HORIZON = 1200
ADMISSION_LIMIT = 3000.0
MIN_SERVED = 100_000


def _scaled_spec(horizon: int):
    spec = api.get_fleet("fleet-3tenant-hetero")
    tenants = tuple(
        api.replace(t, scenario=api.replace(t.scenario, rate=QUICK_RATES[t.name],
                                            horizon=horizon))
        for t in spec.tenants)
    return api.replace(spec, name=f"{spec.name}-bench", tenants=tenants,
                       admission_limit=ADMISSION_LIMIT)


def _ms(v):
    return None if v is None else v * 1e3


def run(quick: bool = False, *, device="cuda"):
    resolve_device(device)
    horizon = QUICK_HORIZON if quick else FULL_HORIZON
    rep = api.FleetSession.from_spec(_scaled_spec(horizon), device=device).serve()
    s, wall = rep["summary"], rep["serve_wall_s"]

    fleet = s["fleet"]
    payload = {
        "fleet": {
            "tenants": fleet["tenants"],
            "horizon_s": horizon,
            "offered": fleet["offered"],
            "requests": fleet["served"],
            "shed": fleet["shed"],
            "shed_rate": fleet["shed_rate"],
            "events": fleet["events"],
            "events_per_s": fleet["events_per_s"],
            "virtual_time_s": fleet["virtual_time_s"],
            "wall_s": wall,
            "reallocations": fleet["reallocations"],
        },
        "tenants": {},
    }
    rows = [
        ("fleet", "fleet.requests", fleet["served"], "completed requests across all tenants"),
        ("fleet", "fleet.events_per_s", round(fleet["events_per_s"], 0),
         "shared event-loop processing rate"),
        ("fleet", "fleet.shed_rate", round(fleet["shed_rate"], 4),
         "fleet-wide load-shedding fraction"),
    ]
    for name, t in s["tenants"].items():
        res = {
            "offered": t["arrived"],
            "served": t["served"],
            "shed": t["shed"],
            "shed_rate": t["shed_rate"],
            "priority": t["priority"],
            "share": t["share"],
            "p50_ms": _ms(t["p50"]),
            "p95_ms": _ms(t["p95"]),
            "p99_ms": _ms(t["p99"]),
            "inv_p99": None if t["p99"] is None else 1.0 / t["p99"],
        }
        payload["tenants"][name] = res
        rows += [
            ("fleet", f"{name}.p99_ms",
             None if res["p99_ms"] is None else round(res["p99_ms"], 1),
             "per-tenant tail latency on the shared cluster"),
            ("fleet", f"{name}.shed_rate", round(res["shed_rate"], 4),
             "priority-graded load shedding"),
        ]

    if fleet["served"] < MIN_SERVED:
        raise AssertionError(
            f"fleet completed only {fleet['served']} requests (< {MIN_SERVED}); "
            f"the benchmark must exercise CI-scale load")
    save_results("fleet_throughput", payload, device=device)
    return rows


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    bench_main(run)
