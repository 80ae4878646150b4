"""Telemetry interval-query micro-benchmark (the counterpart of the
reference's ``benchmarks/telemetry_queries.py``: same streams, rows and
payload keys, plus the payload's device block).

    PYTHONPATH=src python -m repro_torch.launch.telemetry_queries [--quick] \
        [--device cpu] [--out DIR]

The control loop calls ``completed_in`` / ``arrived_in`` / ``latencies`` /
``load_history`` every adaptation interval; they are bisect windows over
sorted record arrays, so per-query cost must stay flat as the record count
grows. Per-query wall time on a small and a large synthetic record stream
(non-decreasing virtual times, the same ``default_rng(0)`` draws as the
reference) and after a closed-loop run of the port's ``RuntimeEnv``;
**asserts** the large/small cost ratio stays below ``MAX_FLAT_RATIO``.

The queries are host NumPy: they are timed with ``device="cpu"`` (nothing
to synchronise), and ``device`` only names where the run was taken.
"""
from __future__ import annotations

import numpy as np

from repro_torch import api
from repro_torch.cluster import RuntimeEnv
from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results, time_fn
from repro_torch.serving.telemetry import Telemetry

GROWTH = 16              # large run has GROWTH x the records of the small
MAX_FLAT_RATIO = 4.0     # per-query cost may not grow ~GROWTH x


def _fill(n_records: int, rate: float = 20.0) -> Telemetry:
    """A telemetry store as the event loop would leave it after serving
    ``n_records`` requests at ``rate`` req/s of virtual time."""
    tel = Telemetry()
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.exponential(1.0 / rate, size=n_records))
    lat = rng.uniform(0.05, 1.5, size=n_records)
    for i in range(n_records):
        tel.record_arrival(float(t[i]))
    for i in range(n_records):                 # finishes non-decreasing
        tel.record_completion(i, float(t[i]), float(t[i] + lat[i]))
    return tel


def _time_queries(tel: Telemetry, horizon: float, *, repeats: int = 200) -> float:
    """Mean wall seconds of one interval's query bundle (what
    ``RuntimeEnv.step`` issues every 10 s decision), min of 3 passes over
    the whole ``repeats``-bundle loop."""
    def bundle():
        for k in range(repeats):
            lo = (k % 10) * horizon / 10.0
            hi = lo + 10.0
            tel.completed_in(lo, hi)
            tel.arrived_in(lo, hi)
            tel.latencies(lo, hi)
            tel.load_history(hi, 120)

    return time_fn(bundle, reps=3, warmup=1, device="cpu").best / repeats


def run(quick: bool = False, *, device="cuda"):
    resolve_device(device)
    small_n = 5_000 if quick else 20_000
    large_n = small_n * GROWTH
    rate = 20.0
    small = _time_queries(_fill(small_n, rate), small_n / rate)
    large = _time_queries(_fill(large_n, rate), large_n / rate)
    ratio = large / max(small, 1e-12)

    # a closed-loop run: query cost at its end must match the synthetic flat
    # profile (the event loop records through the sorted fast path)
    exp = api.ExperimentSpec(
        pipeline=api.get_pipeline("serve3"),
        scenario=api.replace(api.get_scenario("bursty"), rate=25.0, seed=11,
                             horizon=60 if quick else 180),
        controller=api.get_controller("greedy"))
    env = RuntimeEnv(exp.pipeline.build(), exp.scenario.build_arrivals(),
                     horizon=exp.scenario.horizon)
    done = False
    while not done:
        _, _, done, _ = env.step(env.default_config())
    live = _time_queries(env.runtime.telemetry, env.runtime.now, repeats=50)

    if not ratio < MAX_FLAT_RATIO:
        raise AssertionError(
            f"interval-query cost grew {ratio:.1f}x across a {GROWTH}x record "
            f"growth (limit {MAX_FLAT_RATIO}x): queries are no longer flat")

    payload = {
        "small_records": small_n,
        "large_records": large_n,
        "per_query_us_small": small * 1e6,
        "per_query_us_large": large * 1e6,
        "cost_ratio": ratio,
        "max_flat_ratio": MAX_FLAT_RATIO,
        "per_query_us_live_run": live * 1e6,
    }
    save_results("telemetry_queries", payload, device=device)
    return [
        ("telemetry", "per_query_us_small", round(small * 1e6, 2), f"{small_n} records"),
        ("telemetry", "per_query_us_large", round(large * 1e6, 2), f"{large_n} records"),
        ("telemetry", "cost_ratio", round(ratio, 2), f"flat gate: < {MAX_FLAT_RATIO}"),
        ("telemetry", "per_query_us_live_run", round(live * 1e6, 2),
         "queries after a closed-loop runtime run"),
    ]


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    bench_main(run)
