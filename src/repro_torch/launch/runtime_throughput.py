"""Event-driven runtime throughput (the counterpart of the reference's
``benchmarks/runtime_throughput.py``: same runs, rows and payload keys,
plus the payload's device block): requests/s across arrival scenarios,
simulation speed (virtual seconds per wall second), tail latency, and the
control loop's decision-to-effect latency (wall time from invoking the
controller to the configuration being live in the runtime; variant
switches additionally pay ``COLD_START_SECONDS`` of virtual unavailability).

    PYTHONPATH=src python -m repro_torch.launch.runtime_throughput [--quick] \
        [--device cpu] [--out DIR]

The registered "serve3" pipeline x every arrival scenario x the greedy
controller, one ``Session`` each, in virtual time: the greedy controller
and the runtime are host NumPy, so ``device`` only names where the run was
taken. ``submitted``, ``served``, ``virtual_rps``, ``p50/p95/p99_ms``,
``mean_batch``, ``switches`` and ``cold_start_s`` equal the reference's;
the wall fields are this host's.
"""
from __future__ import annotations

import numpy as np

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results
from repro_torch.serving import SCENARIOS
from repro_torch.serving.runtime import COLD_START_SECONDS


def _ms(v):
    # summary percentiles are None (not NaN) when nothing completed
    return None if v is None else v * 1e3


def run(quick: bool = False, *, device="cuda"):
    resolve_device(device)
    horizon = 60 if quick else 180
    rows, payload = [], {}
    for name in SCENARIOS:
        exp = api.ExperimentSpec(
            pipeline=api.get_pipeline("serve3"),
            scenario=api.replace(api.get_scenario(name), rate=25.0, seed=11,
                                 horizon=horizon),
            controller=api.get_controller("greedy"))
        apply_wall, switches = [], 0

        def on_step(env, cfg, info):
            nonlocal switches
            apply_wall.append(info["apply_wall_s"])
            switches += info["switched"]

        rep = api.Session.from_spec(exp, device=device).serve(on_step=on_step)
        summary, wall = rep["summary"], rep["serve_wall_s"]
        effect_ms = [(d + a) * 1e3
                     for d, a in zip(rep["decide_wall_s"], apply_wall, strict=True)]
        res = {
            "submitted": summary["submitted"],
            "served": summary["served"],
            "virtual_rps": summary["throughput_rps"],
            "wall_rps": summary["served"] / max(wall, 1e-9),
            "sim_speedup_x": summary["virtual_now"] / max(wall, 1e-9),
            "p50_ms": _ms(summary["p50"]),
            "p95_ms": _ms(summary["p95"]),
            "p99_ms": _ms(summary["p99"]),
            "mean_batch": summary["mean_batch_size"],
            "decision_to_effect_ms": float(np.mean(effect_ms)),
            "switches": switches,
            "cold_start_s": COLD_START_SECONDS,
        }
        payload[name] = res
        rows += [
            ("runtime", f"{name}.virtual_rps", round(res["virtual_rps"], 1),
             "served request rate in virtual time"),
            ("runtime", f"{name}.wall_rps", round(res["wall_rps"], 0),
             "event-loop processing rate"),
            ("runtime", f"{name}.p95_ms",
             None if res["p95_ms"] is None else round(res["p95_ms"], 1),
             "tail latency under the greedy controller"),
            ("runtime", f"{name}.decision_to_effect_ms",
             round(res["decision_to_effect_ms"], 2), "controller invocation -> config live"),
        ]
        if summary["served"] != summary["submitted"]:
            raise AssertionError(
                f"{name}: dropped {summary['submitted'] - summary['served']} requests")
    save_results("runtime_throughput", payload, device=device)
    return rows


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    bench_main(run)
