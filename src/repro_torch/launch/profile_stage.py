"""Where the time of a stage goes on the card: torch.profiler over one
serving batch (prefill forward) per variant and a few decode steps, at full
width.

    PYTHONPATH=src python -m repro_torch.launch.profile_stage [--out chiprun_out/profile]

The shapes are those of ``chip_smoke.py``'s serve and decode phases:
llama3.2-1b and starcoder2-3b at full width, batch 4, 32-token prompts, a
1024-slot cache, 4 decode steps after a warm-up.

For each window it prints wall time, summed device kernel time, the
device's idle share (1 - kernel time / wall time), the number of kernel
launches, and the top kernels by device time; with ``--out`` it also writes
a Chrome trace per window. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import api

ARCHS_PROFILED = ("llama3.2-1b", "starcoder2-3b")
BATCH, SEQ, CONTEXT, STEPS, TOP = 4, 32, 1024, 4, 12


def _report(name: str, prof, wall_s: float, out: Path | None):
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(f"{name}: wall {wall_s * 1e3:.3f} ms, device kernels {busy_us / 1e3:.3f} ms "
          f"in {launches} launches, idle share {1 - busy_us / 1e3 / (wall_s * 1e3):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"{name}.json"))


def _window(name, fn, *, out):
    fn()                                   # warm-up: kernel build, allocator, cuBLAS handles
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(name, prof, wall, out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for one Chrome trace per window")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    for i, name in enumerate(ARCHS_PROFILED):
        cfg = ARCHS[name]
        model = api.init_model(i, cfg, device=dev)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, SEQ)),
                               dtype=torch.int32, device=dev)

        def serve_batch():
            with torch.inference_mode():
                logits, _ = api.forward(model, {"tokens": toks}, cfg)
                torch.argmax(logits, dim=-1).cpu()

        _window(f"{name}_serve_batch", serve_batch, out=args.out)

        cache = api.init_cache(cfg, BATCH, CONTEXT, device=dev)
        tok = toks[:, :1].contiguous()

        def decode_steps():
            nonlocal cache
            with torch.inference_mode():
                for _ in range(STEPS):
                    logits, cache = api.decode_step(model, {"tokens": tok}, cache, cfg)
                    torch.argmax(logits[:, -1:], dim=-1).cpu()

        _window(f"{name}_decode_{STEPS}_steps", decode_steps, out=args.out)
        del model, cache
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
