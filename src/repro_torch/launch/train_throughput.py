"""Training-rollout throughput on one device (the counterpart of the
reference's ``benchmarks/train_throughput.py``): the vectorized analytic
env (``core.vecenv.vec_rollout``, every env of a batch stepped together
on ``device``) against the legacy per-step loop (one NumPy ``PipelineEnv``
step per iteration, the policy on ``device``), at several ``num_envs``.

    PYTHONPATH=src python -m repro_torch.launch.train_throughput [--quick] \
        [--device cpu] [--out DIR]

Metrics are environment steps/s and episodes/s of on-policy rollout
collection, the hot path PPO training spends its time in. Each side's
figure is the minimum of ``reps`` passes (``timing.time_interleaved``:
passes of all sides interleave, the device synchronised inside the
clock); a legacy pass is ``legacy_eps`` episodes, a vectorized pass one
call of ``num_envs`` episodes. The reference's ">= 10x at 32 envs" is a
CPU-XLA figure: the speedup is reported here, not claimed.

Payload: the reference's keys, except
  * ``compile_s`` -> ``first_pass_s``: nothing is jitted; the first,
    untimed pass of each point (allocator growth, cuBLAS handles) is
    reported under its own name;
  * ``jax`` -> ``torch``: the framework's version;
  * ``device``: the device block of ``bench.save_results`` in place of the
    reference's platform string.

``run``'s sizing keywords (``env_counts``, ``seconds``, ``legacy_eps``,
``reps``) default to the reference's own values; smaller ones make a short
drive.
"""
from __future__ import annotations

import platform

import numpy as np
import torch

from repro_torch import api
from repro_torch.cluster import PipelineEnv
from repro_torch.core import vecenv
from repro_torch.core.ppo import OPDTrainer, PPOConfig
from repro_torch.device import resolve_device
from repro_torch.launch.bench import save_results
from repro_torch.timing import time_fn, time_interleaved

PIPELINE = "paper-4stage"
SCENARIO = "fluctuating"
ENV_COUNTS = (1, 8, 32)


def run(quick: bool = False, *, device="cuda", env_counts=ENV_COUNTS,
        seconds: int | None = None, legacy_eps: int | None = None,
        reps: int | None = None):
    dev = resolve_device(device)
    seconds = seconds or (300 if quick else 1200)       # 30 / 120 decision steps
    legacy_eps = legacy_eps or (2 if quick else 4)
    # quick keeps more reps so the figure stays stable on a noisy shared host
    reps = reps or (10 if quick else 5)
    scen = api.get_scenario(SCENARIO)
    pipe = api.get_pipeline(PIPELINE).build()

    def make_env(seed):
        return PipelineEnv(pipe, scen.train_trace(seed, seconds=seconds), seed=seed)

    tr = OPDTrainer(pipe, make_env, ppo=PPOConfig(), seed=0, device=dev)
    env0 = make_env(0)
    n_steps = env0.n_steps
    tr._rollout(env0, False)                # warm-up outside the clock

    def legacy_pass():
        for e in range(1, legacy_eps + 1):
            tr._rollout(make_env(e), False)

    tables = vecenv.tables_from_pipeline(pipe, device=dev)
    passes, first = [], {}
    for n_envs in env_counts:
        traces = torch.as_tensor(
            np.stack([make_env(100 + i).trace for i in range(n_envs)]).astype(np.float32),
            device=dev)

        def vec_pass(traces=traces, n_envs=n_envs):
            vecenv.vec_rollout(tr.params, tables, traces,
                               vecenv.env_generators(0, range(n_envs), dev),
                               n_steps=n_steps, weights=env0.w)
        first[n_envs] = time_fn(vec_pass, reps=1, warmup=0, device=dev).best
        passes.append(vec_pass)
    timings = time_interleaved([legacy_pass] + passes, reps=reps, warmup=0, device=dev)

    wall = timings[0].best
    legacy = {"episodes": legacy_eps, "wall_s": wall,
              "episodes_per_s": legacy_eps / wall,
              "steps_per_s": legacy_eps * n_steps / wall}
    vec = {}
    for n_envs, t in zip(env_counts, timings[1:], strict=True):
        vec[str(n_envs)] = {"episodes": n_envs, "wall_s": t.best,
                            "first_pass_s": first[n_envs],
                            "episodes_per_s": n_envs / t.best,
                            "steps_per_s": n_envs * n_steps / t.best}

    top = str(max(env_counts))
    speedup = vec[top]["episodes_per_s"] / legacy["episodes_per_s"]
    payload = {
        "mode": "quick" if quick else "full",
        "pipeline": PIPELINE,
        "scenario": SCENARIO,
        "steps_per_episode": n_steps,
        "legacy": legacy,
        "vectorized": vec,
        f"speedup_episodes_at_{top}": speedup,
        "torch": torch.__version__,
        "python": platform.python_version(),
    }
    save_results("train_throughput", payload, device=dev)

    rows = [("train_throughput", "legacy.steps_per_s", round(legacy["steps_per_s"], 1), "")]
    rows += [("train_throughput", f"vec{n}.steps_per_s",
              round(vec[str(n)]["steps_per_s"], 1), "") for n in env_counts]
    rows.append(("train_throughput", f"speedup_episodes_at_{top}", round(speedup, 1),
                 "reported, not claimed: the reference's >= 10x is a CPU-XLA figure"))
    return rows


if __name__ == "__main__":
    from repro_torch.launch.bench import bench_main

    bench_main(run)
