"""Min-of-k wall-clock timing for device work — the one timing loop the
stage executor and the calibration grid share (port of ``repro/timing.py``).

Protocol, as in the reference:
  * ``warmup`` untimed calls first, so first-call costs (kernel builds,
    cuBLAS handles, allocator growth) never land inside a timed region;
  * each timed pass calls the function and then, for a CUDA device,
    ``torch.cuda.synchronize(device)`` inside the clock, so asynchronous
    launches cannot end the clock early; nothing is synchronised for the CPU;
  * ``reps`` timed passes, and the *minimum* is the figure of merit — on a
    shared host the min is the undisturbed run, the mean is the noise.

``time_interleaved`` times several functions in interleaved rounds
(fn_a, fn_b, fn_a, fn_b, ...) so a host-level slowdown lands on every side
of a speedup ratio instead of whichever ran while it lasted.

Reads from the device to the host (``.item()``, ``.cpu()``) belong OUTSIDE
the timed callables.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Timing:
    """One function's timing: ``best`` = min seconds per pass across reps."""
    best: float
    times: tuple[float, ...]

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)


def _sync_fn(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


def time_interleaved(fns, *, reps: int = 3, warmup: int = 1,
                     device="cpu") -> list[Timing]:
    """Time each callable in ``fns`` over ``reps`` interleaved rounds, with
    ``device`` synchronised inside each timed window. Returns one
    ``Timing`` per fn, in order."""
    fns = list(fns)
    if reps < 1:
        raise ValueError("reps must be >= 1")
    sync = _sync_fn(device)
    for _ in range(warmup):
        for fn in fns:
            fn()
            sync()
    walls: list[list[float]] = [[] for _ in fns]
    for _ in range(reps):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn()
            sync()
            walls[i].append(time.perf_counter() - t0)
    return [Timing(best=min(w), times=tuple(w)) for w in walls]


def time_fn(fn, *, reps: int = 3, warmup: int = 1, device="cpu") -> Timing:
    """Min-of-``reps`` timing of one callable (see module docstring)."""
    return time_interleaved([fn], reps=reps, warmup=warmup, device=device)[0]
