"""Every port launcher from one command (the counterpart of the reference's
``benchmarks/run.py``):

    PYTHONPATH=src python -m repro_torch.launch.run [--quick] [--out DIR] \
        [--device cpu] [--only fig3,runtime,...]

Emits ``benchmark,metric,value,reference`` CSV and writes each suite's JSON
to ``--out`` (default ``chiprun_out/figures``). ``runtime_train`` and
``calibration`` keep their own launchers' signatures; the adapters here
give them ``run(quick, device)`` and write their payloads beside the
others (``runtime_train_throughput.json``; ``calibration.json`` and
``table.json``).
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.launch import (bench, fig3_predictor, fig6_decision_time,
                                fig7_convergence, fig45_workloads, fleet_throughput,
                                roofline, runtime_throughput, telemetry_queries,
                                train_throughput)


def runtime_train(quick: bool = False, *, device="cuda"):
    """``launch/runtime_train_throughput.py`` at its defaults (quick: 30 s
    episodes, 1 and 4 envs, one rep)."""
    from repro_torch.launch import runtime_train_throughput as rtt
    kw = {"horizon": 30, "env_counts": (1, 4), "reps": 1, "legacy_eps": 1} if quick else {}
    payload = rtt.run(device, log=lambda m: print(m, file=sys.stderr), **kw)
    bench.save_results("runtime_train_throughput", payload, device=device)
    return [("runtime_train", f"twin{k}.episodes_per_s", round(v["episodes_per_s"], 3),
             f"legacy {payload['legacy']['episodes_per_s']:.3f}")
            for k, v in payload["twin"].items()]


def calibration(quick: bool = False, *, device="cuda"):
    """``launch/calibrate.py``'s grid (quick: the archs' smoke configs at
    batches 1, 2, 4 and 2 reps) and its fitted table, as its ``main`` runs
    them (TF32 off on the card)."""
    import torch

    from repro_torch.cluster.executor import StageExecutor
    from repro_torch.launch import calibrate
    ex = StageExecutor(device, smoke=quick)
    if ex.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kw = {"batches": (1, 2, 4), "reps": 2} if quick else {}
    payload = calibrate.run(ex, log=lambda m: print(m, file=sys.stderr), **kw)
    calibrate.save(payload, bench.results_dir())
    return [("calibration", "fit_mre_mean", round(payload["fit_mre_mean"], 4), ""),
            ("calibration", "hit_rate_repeat", payload["cache"]["hit_rate_repeat"],
             ">= 0.9")]


SUITES = {
    "fig3": fig3_predictor.run,
    "fig45": fig45_workloads.run,
    "fig6": fig6_decision_time.run,
    "fig7": fig7_convergence.run,
    "roofline": roofline.run,
    "runtime": runtime_throughput.run,
    "train": train_throughput.run,
    "runtime_train": runtime_train,
    "telemetry": telemetry_queries.run,
    "fleet": fleet_throughput.run,
    "calibration": calibration,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of: " + ",".join(SUITES))
    args = bench.bench_args(argv, parser=ap)
    wanted = args.only.split(",") if args.only else list(SUITES)
    unknown = [n for n in wanted if n not in SUITES]
    if unknown:
        raise SystemExit(f"unknown suite(s) {unknown}; choose from {list(SUITES)}")
    print("benchmark,metric,value,reference")
    failures = []
    for name in wanted:
        t0 = time.time()
        try:
            rows = SUITES[name](quick=args.quick, device=args.device)
        except Exception as e:  # noqa: BLE001 (keep the harness running)
            failures.append(name)
            traceback.print_exc()
            print(f"{name},ERROR,{type(e).__name__}: {e},", file=sys.stderr)
            continue
        for r in rows:
            print(",".join(str(x).replace(",", ";") for x in r))
        print(f"# {name} done in {time.time() - t0:.1f}s", file=sys.stderr)
    if failures:
        raise SystemExit(f"benchmark failures: {failures}")


if __name__ == "__main__":
    main()
