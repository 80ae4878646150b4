"""Read the numbers that set the limits of ``correct``, on the chip, in one
process: for each seed, the cell's own set-up and a short window at the
cell's own load, then the gap statistics of the program and, on the first
``--control-seeds`` seeds, of the control (the reference computed in fp8,
put in the program's place), each with the harness's own decision on it
(``correct``, ``control_correct``: ``harness.passes`` on the checks with the
program's or the control's tokens). The benchmark's own runs never run the
control.
``--fault`` plants a fault in the program underneath the harness first: each
stage's output token altered at one position a row (``token_altered``), or
each stage returning its input unchanged (``unchanged``).

    python3 portbench/calibrate.py --workload edge4.steady120 --seeds 1 2 3 \\
        --seconds 8 --control-seeds 3 --out build/calibrate
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--segment-s", type=int, default=2,
                   help="virtual seconds of traffic a segment: the cell's load, fewer requests")
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default="build/calibrate")
    p.add_argument("--fault", choices=("token_altered", "unchanged"))
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.fault:
        plant(args.fault)
    cell = harness.Cell(args.workload, root=ROOT)
    cell.segment_s = args.segment_s
    with open(out / f"{args.workload}.jsonl", "a") as f:
        for k, seed in enumerate(args.seeds):
            t = time.perf_counter()
            window = cell.run(seed, args.seconds, keep=True)
            served = len(window["rec"].batches)
            checks, acc, details = cell.judge(window, control=k < args.control_seeds)
            low = details.pop("control_checks", None)
            line = {"workload": args.workload, "seed": seed, "batches": served,
                    "fault": args.fault, "correct": harness.passes(checks),
                    "control_correct": None if low is None else harness.passes(low),
                    "checks": checks, "control_checks": low,
                    "served": len(acc["service_s"]), "lost": acc["lost"],
                    "misrouted": acc["wrong"], "details": details,
                    "wall_s": time.perf_counter() - t,
                    "device": torch.cuda.get_device_name(0)}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0


def plant(fault: str):
    from repro_torch.serving.engine import StageServer

    orig = StageServer.execute

    def token_altered(self, z, tokens):
        out = orig(self, z, tokens).copy()
        mid = out.shape[1] // 2
        out[:, mid] = (out[:, mid] + 1) % self.variants[z].vocab
        return out

    def unchanged(self, z, tokens):
        return tokens % self.variants[z].vocab

    StageServer.execute = {"token_altered": token_altered, "unchanged": unchanged}[fault]


if __name__ == "__main__":
    sys.exit(main())
