"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 50 \
        [--smoke] [--batch 8] [--seq-len 256] [--microbatch 2] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --full \
        --batch 4 --seq-len 1024 --steps 3

Runs the real train step (``models.steps.make_train_step``) on
``synthetic_lm_batches(seed=0)`` from ``init_model(0, ...)``: the reduced
config with ``--smoke`` (the default), the published one with ``--full``.
It runs on ``cuda`` unless ``--device cpu`` is given, and prints the
reference's lines, then the mean step time after the first step, tokens/s
and, on a CUDA device, the peak memory allocated (with the card's name).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import api, steps
from repro_torch.train import adamw_init


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train an LM of ARCHS on synthetic batches")
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args, *, on_step=None, log=print) -> dict:
    """Train as ``args`` say. ``on_step(step, model, metrics)`` is called
    with step 0 (and no metrics) before the first step and after every
    step. Returns the model, the optimiser state and the per-step metrics
    and wall times (synchronised on a CUDA device)."""
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch].smoke() if args.smoke else ARCHS[args.arch]
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    log(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {n_dev} device(s)")
    model = api.init_model(0, cfg, device=dev)
    opt = adamw_init(model)
    train = steps.make_train_step(cfg, lr=args.lr, microbatch=args.microbatch)
    data = synthetic_lm_batches(vocab=cfg.vocab, seq_len=args.seq_len, batch=args.batch,
                                seed=0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if on_step:
        on_step(0, model, None)
    history, walls = [], []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        sync()
        t = time.perf_counter()
        model, opt, metrics = train(model, opt, batch)
        sync()
        walls.append(time.perf_counter() - t)
        history.append({k: float(v) for k, v in metrics.items()})
        if step % 10 == 0 or step == 1:
            log(f"step {step:4d} loss={history[-1]['loss']:8.4f} "
                f"grad_norm={history[-1]['grad_norm']:7.3f} "
                f"({(time.time() - t0) / step:.2f}s/step)")
        if on_step:
            on_step(step, model, metrics)
    steady = walls[1:] or walls
    step_s = sum(steady) / len(steady)
    out = {"model": model, "opt": opt, "history": history, "walls": walls,
           "step_s": step_s, "tokens_per_s": args.batch * args.seq_len / step_s,
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                        if dev.type == "cuda" else None)}
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"{len(walls)} steps on {where}, {step_s * 1e3:.1f} ms/step"
        f"{' after the first' if len(walls) > 1 else ''}, "
        f"{out['tokens_per_s']:.1f} tokens/s"
        + (f", peak memory allocated {out['peak_gib']:.2f} GiB"
           if out["peak_gib"] is not None else ""))
    log("done")
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
