"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 portbench/run.py --workload edge4.steady120 --seed 7 --seconds 30 --trace 0

It needs an NVIDIA GPU: without one (or with fewer than the cell asks for)
it exits with code 3 and prints no result. The program's kernels are built
into ``build/kernels`` of this checkout on the first run and reused after.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton")):
    os.environ[var] = str(ROOT / sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness, spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program under test is missing: {e}", file=sys.stderr)
        return 5
    run = harness.Cell(args.workload, root=ROOT, bench=bench)
    window = run.run(args.seed, args.seconds, bool(args.trace))
    if window["forbidden"]:
        print(f"portbench: the run loaded {window['forbidden']}", file=sys.stderr)
        return 4
    import time

    t = time.perf_counter()
    checks, acc, _ = run.judge(window)
    print(f"checks: {time.perf_counter() - t:.3f} s", file=sys.stderr)
    out = harness.report(run, window, bool(args.trace), checks, acc)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
