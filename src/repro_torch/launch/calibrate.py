"""Stage calibration on the card: measured against predicted stage latency.

    PYTHONPATH=src python -m repro_torch.launch.calibrate [--out chiprun_out/calibrate]
    PYTHONPATH=src python -m repro_torch.launch.calibrate --device cpu --smoke \
        --batches 1 2 4 --reps 2

Runs the ``StageExecutor`` grid — serve2's four archs at full width, quants
bf16 and int8, batches 1..32 (serve2's ``b_max``) — and reports, per row,
the CUDA-graph replay latency (the eager step beside it), the kernel
launches of one captured step, the step's flops and bytes and its bound on
an H100 SXM (the larger of bytes over 3.35 TB/s and flops over 989 TFLOP/s
in bf16), and, per variant:

  * the measured min-of-k ``latency(b)`` curve and its eager twin;
  * the least-squares ``(alpha, beta)`` fit and its mean relative error;
  * the analytic ``perf_model`` prediction and its error against the
    measurement (the perf model describes a TPU v5e: reported, not gated).

The whole grid then repeats against the executor's cache:
``hit_rate_repeat`` must be at least 0.9 (it should be 1.0). The payload
(the keys of the reference's ``benchmarks/stage_calibration.py``) goes to
``<out>/calibration.json`` and the fitted table, with the device's name and
power limit in its meta, to ``<out>/table.json``, which
``PipelineSpec(perf_source="calibrated", calibration=<path>)`` loads. The
table is fitted on the graph latencies. On the CPU the latencies are the
eager steps' and no share of the H100 bound is computed.
"""
from __future__ import annotations

import argparse
import json
import platform
from pathlib import Path

import numpy as np
import torch

from repro_torch.cluster.calibration import (CalibrationTable, fit_alpha_beta,
                                             mean_relative_error, predict)
from repro_torch.cluster.executor import StageExecutor
from repro_torch.cluster.perf_model import variant_from_arch

ARCHS = ("whisper-small", "xlstm-125m", "llama3.2-1b", "starcoder2-3b")   # serve2
QUANTS = ("bf16", "int8")
BATCHES = (1, 2, 4, 8, 16, 32)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_BF16 = 989e12              # dense bf16 tensor cores, H100 SXM data sheet


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time an H100 SXM could take for one step, and what bounds it."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def run(ex: StageExecutor, *, archs=ARCHS, batches=BATCHES, reps: int = 5,
        log=print) -> dict:
    """Measure the grid on ``ex``, fit, repeat, and return the payload."""
    grid = [(a, q, b) for a in archs for q in QUANTS for b in batches]
    on_card = ex.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(ex.device)
    timings, rows = [], []
    for a, q, b in grid:
        t = ex.measure(a, b, q, reps=reps)
        timings.append(t)
        bound, by = bound_s(t.flops, t.bytes)
        row = {"arch": a, "quant": q, "batch": b, "graph_s": t.latency_s if on_card else None,
               "eager_s": t.eager_latency_s, "compile_s": t.compile_s,
               "launches": t.launches, "replays": t.replays, "flops": t.flops,
               "bytes": t.bytes, "bound_s": bound, "bound_by": by,
               "share": bound / t.latency_s if on_card else None}
        rows.append(row)
        log("calibrate: " + json.dumps(row))

    variants: dict[str, dict] = {}
    for t, row in zip(timings, rows, strict=True):
        v = variants.setdefault(f"{t.arch}:{t.quant}", {
            "batches": [], "measured_s": [], "eager_s": [], "flops": [], "bytes": [],
            "roofline_s": [], "compile_s_first": t.compile_s})
        v["batches"].append(t.batch)
        v["measured_s"].append(t.latency_s)
        v["eager_s"].append(t.eager_latency_s)
        v["flops"].append(t.flops)
        v["bytes"].append(t.bytes)
        v["roofline_s"].append(row["bound_s"])
    for name, v in variants.items():
        alpha, beta = fit_alpha_beta(v["batches"], v["measured_s"])
        v["fitted"] = [alpha, beta]
        v["fit_mre"] = mean_relative_error(predict(alpha, beta, v["batches"]),
                                           v["measured_s"])
        arch, quant = name.rsplit(":", 1)
        av = variant_from_arch(ex.arch_config(arch), quant=quant)
        v["analytic"] = [av.alpha, av.beta]
        v["analytic_mre"] = mean_relative_error(predict(av.alpha, av.beta, v["batches"]),
                                                v["measured_s"])

    # repeat pass: every lookup must hit the cache
    hits0, lookups0 = ex.cache.hits, ex.cache.lookups
    for a, q, b in grid:
        ex.measure(a, b, q, reps=1, warmup=0)
    hit_rate_repeat = (ex.cache.hits - hits0) / (ex.cache.lookups - lookups0)

    meta = {"mode": "smoke" if ex.smoke else "full", "reps": reps, "seq_len": ex.seq_len,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": platform.python_version(), "latency": "graph replay" if on_card
            else "eager step", **ex.device_meta()}
    speeds = {ex.device_class: 1.0}          # one device: the reference's 1-device branch
    table = CalibrationTable.from_timings(timings, speeds=speeds, meta=meta)
    payload = {
        "mode": meta["mode"], "device": ex.device_class,
        "device_name": meta["device_name"], "power_limit": meta["power_limit"],
        "variants": variants, "rows": rows,
        "fit_mre_mean": float(np.mean([v["fit_mre"] for v in variants.values()])),
        "analytic_mre_mean": float(np.mean([v["analytic_mre"] for v in variants.values()])),
        "cache": {"lookups": ex.cache.lookups, "hits": ex.cache.hits,
                  "misses": ex.cache.misses, "hit_rate": ex.cache.hit_rate(),
                  "hit_rate_repeat": hit_rate_repeat},
        "speeds": speeds, "table": table.to_dict(),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(ex.device)
                                 if on_card else None),
    }
    for name, v in sorted(variants.items()):
        log(f"calibrate: {name}: alpha {v['fitted'][0]:.6e} s, beta {v['fitted'][1]:.6e} s, "
            f"fit_mre {v['fit_mre']:.4f}, analytic (TPU v5e model) mre "
            f"{v['analytic_mre']:.4f}")
    log(f"calibrate: fit_mre_mean {payload['fit_mre_mean']:.4f}, hit_rate_repeat "
        f"{hit_rate_repeat:.4f}, cache {payload['cache']}, max_memory_allocated "
        f"{payload['max_memory_allocated']}")
    return payload


def save(payload: dict, out) -> Path:
    """Write ``calibration.json`` and ``table.json`` under ``out``; returns
    the table's path."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "calibration.json").write_text(json.dumps(payload, indent=2) + "\n")
    CalibrationTable.from_dict(payload["table"]).save(out / "table.json")
    return out / "table.json"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs (for the CPU)")
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--batches", nargs="+", type=int, default=list(BATCHES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/calibrate")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ex = StageExecutor(args.device, smoke=args.smoke)
    payload = run(ex, archs=args.archs, batches=args.batches, reps=args.reps)
    print(f"calibrate: wrote {save(payload, args.out)}")
    return payload


if __name__ == "__main__":
    main()
