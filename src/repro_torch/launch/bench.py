"""Shared plumbing of the paper-figure launchers (the counterpart of the
reference's ``benchmarks/common.py``): CLI flags, result paths, the trained
OPD policy's cache, CSV emission, the device block of every payload.

Every launcher exposes ``run(quick: bool = False, ..., device="cuda") ->
list[row]``, where a row is (benchmark, metric, value, reference) and
``reference`` is the paper's claim the value is read against (or ""), and a
``__main__`` that delegates to ``bench_main``, so ``--quick``, ``--out DIR``
and ``--device`` behave alike everywhere. The default ``--out`` is
``chiprun_out/figures``; committed results live elsewhere and are never
written by default.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess

import numpy as np
import torch

from repro_torch.device import resolve_device
# the one timing loop (min-of-k, warm-up, the device synchronised inside the
# clock) the launchers share with the stage executor
from repro_torch.timing import time_fn  # noqa: F401

RESULTS_DIR = os.path.join("chiprun_out", "figures")

_OUT_DIR: str | None = None          # --out override, set by bench_args


def results_dir() -> str:
    return _OUT_DIR or RESULTS_DIR


def set_results_dir(path: str | None) -> None:
    """Redirect ``save_results`` and the policy cache to ``path``."""
    global _OUT_DIR
    _OUT_DIR = path


def bench_args(argv=None, *, parser: argparse.ArgumentParser | None = None):
    """The flags every launcher shares: ``--quick`` (CI-sized episode and
    epoch counts), ``--out DIR`` (JSON destination) and ``--device``. Pass
    a pre-built ``parser`` to stack launcher-specific flags on top."""
    ap = parser or argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="reduced episode/epoch counts (CI-sized)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help=f"write JSON results here (default {RESULTS_DIR})")
    ap.add_argument("--device", default="cuda",
                    help="torch device the learned parts run on (default cuda)")
    args = ap.parse_args(argv)
    if args.out:
        set_results_dir(args.out)
    return args


def bench_main(run, argv=None, *, parser=None, kwargs_from_args=None) -> None:
    """Shared ``__main__``: parse the common flags, call ``run(quick=...,
    device=...)`` and print the benchmark,metric,value,reference CSV."""
    args = bench_args(argv, parser=parser)
    kwargs = kwargs_from_args(args) if kwargs_from_args else {}
    print("benchmark,metric,value,reference")
    for r in run(quick=args.quick, device=args.device, **kwargs):
        print(",".join(str(x).replace(",", ";") for x in r))


def device_info(device) -> dict:
    """Where a payload's numbers were taken: for a card its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them, and the
    torch and CUDA versions."""
    dev = resolve_device(device)
    info = {"type": dev.type, "torch": torch.__version__, "cuda": torch.version.cuda}
    if dev.type == "cpu":
        return {**info, "name": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    name, limit = torch.cuda.get_device_name(index), "not measured"
    if shutil.which("nvidia-smi") is not None:
        out = subprocess.run(["nvidia-smi", "-i", str(index),
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        name, limit = (s.strip() for s in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {**info, "name": name, "power_limit": limit}


def save_results(name: str, payload: dict, *, device) -> None:
    """Write ``payload`` plus a top-level ``"device"`` block to
    ``<results_dir>/<name>.json``."""
    os.makedirs(results_dir(), exist_ok=True)
    with open(os.path.join(results_dir(), name + ".json"), "w") as f:
        json.dump({**payload, "device": device_info(device)}, f, indent=1,
                  default=_np_default)


def _np_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


def policy_cache(cache_tag: str | None = None) -> str:
    """Path of the trained OPD policy's cache under the results dir."""
    return os.path.join(results_dir(), "opd_policy.pt" if cache_tag is None
                        else f"opd_policy_{cache_tag}.pt")


def trained_opd(episodes: int = 36, *, seed: int = 0, force: bool = False,
                log=print, pipeline=None, cache_tag: str | None = None,
                device="cuda"):
    """Train (or load cached) OPD policy on the paper's three workload
    regimes, round-robin over episodes, on ``device``. Returns (params,
    trainer_history).

    ``pipeline`` (a PipelineSpec; default the registered "paper-4stage")
    selects the pipeline; pass a cluster-bearing spec for placement-aware
    training together with a distinct ``cache_tag`` (the policy's input
    grows per-node features, so caches are not interchangeable). A cache
    with at least ``episodes`` episodes, trained on a device of the same
    type, is reused; its history stays the one it was trained with."""
    from repro_torch import api
    from repro_torch.cluster import PipelineEnv
    from repro_torch.core import OPDTrainer, PPOConfig
    from repro_torch.core.policy import Policy, head_sizes

    dev = resolve_device(device)
    spec = pipeline or api.get_pipeline("paper-4stage")
    pipe = spec.build()
    kinds = ("steady_low", "fluctuating", "steady_high")

    def make_env(seed_):
        scen = api.get_scenario(kinds[seed_ % 3])
        return PipelineEnv(pipe, scen.train_trace(seed_), seed=seed_)

    cache = policy_cache(cache_tag)
    if not force and os.path.exists(cache):
        blob = torch.load(cache, map_location=dev)
        if blob["episodes"] >= episodes and torch.device(blob["device"]).type == dev.type:
            params = Policy(make_env(0).state_dim, head_sizes(pipe), device=dev)
            params.load_state_dict(blob["params"])
            return params, blob["history"]

    tr = OPDTrainer(pipe, make_env, ppo=PPOConfig(expert_freq=4), seed=seed, device=dev)
    for e in range(1, episodes + 1):
        tr.train_episode(e, env_seed=e)
        if log and (e % 6 == 0 or e == 1):
            log(f"  opd episode {e:3d}/{episodes} "
                f"reward={tr.history['reward'][-1]:9.2f} "
                f"loss={tr.history['loss'][-1]:8.4f} "
                f"expert={tr.history['expert'][-1]}")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    torch.save({"params": tr.params.state_dict(), "history": tr.history,
                "episodes": episodes, "device": str(dev)}, cache)
    return tr.params, tr.history
