"""Closed-loop runtime-episode throughput on one device: the tensor twin of
the discrete-event runtime (``core.runtime_vec``) against the per-step
loop (one NumPy ``RuntimeEnv``/``ServingRuntime`` step per decision
interval, the policy on the same device), at several ``num_envs``.

    PYTHONPATH=src python -m repro_torch.launch.runtime_train_throughput \
        [--device cuda] [--horizon 120] [--envs 1 8 32] [--out chiprun_out/twin]
    PYTHONPATH=src python -m repro_torch.launch.runtime_train_throughput --device cpu

The counterpart of ``benchmarks/runtime_train_throughput.py`` (serve3-hetero,
bursty arrivals at 25 req/s, on-policy rollout collection, the hot path of
``train_backend="runtime"`` PPO training). Each side takes the minimum of
``--reps`` passes after a warm-up pass, with the device synchronised
inside the clock (``timing.time_interleaved``: passes of all sides
interleave). On a CUDA device the twin runs with its event-loop blocks
captured in CUDA graphs, and again eagerly (``--eager-reps`` passes of its
own after the others, no warm-up: the captured passes ran the same
kernels; 0 skips them); on the CPU eagerly only. Per point it reports
episodes/s, events per episode (the twin's own count), loop iterations and
host reads per interval (one per block of ``CHECK_EVERY`` iterations), and
kernels per iteration and per event (one eager interval under
torch.profiler, CUDA only). Writes ``<out>/runtime_train_throughput.json``.
"""
from __future__ import annotations

import argparse
import json
import platform
from pathlib import Path

import torch

from repro_torch import api
from repro_torch.cluster.env import RuntimeEnv
from repro_torch.core import runtime_vec as rv
from repro_torch.core.mdp import ADAPTATION_INTERVAL
from repro_torch.core.ppo import OPDTrainer, PPOConfig
from repro_torch.core.vecenv import env_generators, tables_from_pipeline
from repro_torch.device import resolve_device
from repro_torch.serving import make_arrivals
from repro_torch.timing import time_interleaved

PIPELINE = "serve3-hetero"
ARRIVALS = ("bursty", 25.0)
ENV_COUNTS = (1, 8, 32)


def kernels_per_iteration(tables, eps, max_wait: float) -> float:
    """CUDA kernels one eager event-loop iteration launches: one interval's
    ``advance`` under torch.profiler, its kernels over its iterations."""
    from torch.profiler import ProfilerActivity, profile
    state = rv.init_state(tables, eps)
    loop = rv.EventLoop(tables, eps.times.shape[0], max_wait, device=eps.times.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop.advance(state, eps.times, float(ADAPTATION_INTERVAL))
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")
    return kernels / (loop.blocks * rv.CHECK_EVERY)


def run(device="cuda", *, horizon: int = 120, env_counts=ENV_COUNTS, reps: int = 3,
        eager_reps: int | None = None, legacy_eps: int = 4, log=print) -> dict:
    dev = resolve_device(device)
    kind, rate = ARRIVALS
    pipe = api.get_pipeline(PIPELINE).build()
    n_steps = max(1, horizon // ADAPTATION_INTERVAL)

    def arrivals(seed):
        return make_arrivals(kind, rate=rate, seed=seed)

    def make_env(seed):
        return RuntimeEnv(pipe, arrivals(seed), horizon=horizon)

    tr = OPDTrainer(pipe, make_env, ppo=PPOConfig(), seed=0, device=dev)
    tables, weights = tables_from_pipeline(pipe, device=dev), tr._weights
    tr._rollout(make_env(0), False)             # warm-up outside the clock

    def legacy_pass():
        for e in range(1, legacy_eps + 1):
            tr._rollout(make_env(e), False)

    modes = ([True] + ([False] if eager_reps != 0 else [])) if dev.type == "cuda" else [False]
    groups, points, outs = {m: [] for m in modes}, [], {}
    for capture in modes:
        for n_envs in env_counts:
            seeds = range(100, 100 + n_envs)
            eps = rv.to_device(rv.stack_episodes([rv.episode_arrivals(arrivals(s), horizon)
                                            for s in seeds]), dev)
            key = (n_envs, capture)

            def one(eps=eps, seeds=seeds, capture=capture, key=key):
                outs[key] = rv.vec_rollout(
                    tr.params, tables, eps, env_generators(0, seeds, dev),
                    n_steps=n_steps, weights=weights, capture=capture)
            points.append((key, eps))
            groups[capture].append(one)
    # the warm-up pass (the first capture, allocator growth) is untimed
    timings = time_interleaved([legacy_pass] + groups[modes[0]], reps=reps, warmup=1,
                               device=dev)
    if len(modes) > 1:
        timings += time_interleaved(groups[False], warmup=0, device=dev,
                                    reps=reps if eager_reps is None else eager_reps)
    wall = timings[0].best
    legacy = {"episodes": legacy_eps, "wall_s": wall, "episodes_per_s": legacy_eps / wall,
              "steps_per_s": legacy_eps * n_steps / wall}
    log(f"twin: legacy RuntimeEnv loop ({dev.type} policy), {legacy_eps} episodes of "
        f"{horizon} s: {wall:.4f} s, {legacy['episodes_per_s']:.3f} episodes/s")
    twin = {}
    for ((n_envs, capture), eps), t in zip(points, timings[1:]):
        out = outs[(n_envs, capture)]
        events = out["events"].to(torch.float64).cpu().numpy()
        iters = out["blocks"] * rv.CHECK_EVERY
        row = {"num_envs": n_envs, "capture": capture, "wall_s": t.best,
               "times_s": list(t.times), "episodes_per_s": n_envs / t.best,
               "speedup_vs_legacy": (n_envs / t.best) / legacy["episodes_per_s"],
               "events_per_episode": float(events.mean()),
               "iterations": iters, "host_reads_per_interval": out["blocks"] / n_steps,
               "reward_mean": float(out["rewards"].mean())}
        if dev.type == "cuda" and not capture:
            k_it = kernels_per_iteration(tables, eps, rv.DEFAULT_MAX_WAIT)
            row["kernels_per_iteration"] = k_it
            row["launches_per_event"] = k_it * iters / events.sum()
        if capture:
            row["launches_per_event"] = out["blocks"] / events.sum()
        twin[f"{n_envs}{'' if capture else '-eager'}"] = row
        log(f"twin: vec_rollout {n_envs} envs ({'graph' if capture else 'eager'}): "
            f"{t.best:.4f} s ({', '.join(f'{x:.4f}' for x in t.times)}), "
            f"{row['episodes_per_s']:.3f} episodes/s ({row['speedup_vs_legacy']:.2f}x legacy), "
            f"{row['events_per_episode']:.1f} events/episode, {iters} iterations, "
            f"{row['host_reads_per_interval']:.1f} host reads/interval"
            + (f", {row['kernels_per_iteration']:.1f} kernels/iteration"
               if "kernels_per_iteration" in row else "")
            + (f", {row['launches_per_event']:.4f} launches/event"
               if "launches_per_event" in row else ""))
    return {"pipeline": PIPELINE, "arrivals": {"kind": kind, "rate": rate},
            "horizon": horizon, "steps_per_episode": n_steps,
            "check_every": rv.CHECK_EVERY, "legacy": legacy, "twin": twin,
            "device": str(dev), "device_name": (torch.cuda.get_device_name(dev)
                                                if dev.type == "cuda" else platform.processor()),
            "torch": torch.__version__, "python": platform.python_version()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--horizon", type=int, default=120)
    ap.add_argument("--envs", type=int, nargs="+", default=list(ENV_COUNTS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--eager-reps", type=int, default=None,
                    help="timed passes of the eager loop on a CUDA device (default: --reps; "
                         "0 skips it)")
    ap.add_argument("--legacy-eps", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out/twin")
    args = ap.parse_args()
    payload = run(args.device, horizon=args.horizon, env_counts=args.envs, reps=args.reps,
                  eager_reps=args.eager_reps, legacy_eps=args.legacy_eps)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "runtime_train_throughput.json").write_text(
        json.dumps(payload, indent=1, default=float))
    print(json.dumps({k: payload[k] for k in ("pipeline", "horizon", "device_name")}))


if __name__ == "__main__":
    main()
