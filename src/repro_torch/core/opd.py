"""Algorithm 1 — the online OPD loop: predict load, observe state, select
action, measure decision time d_t, apply configuration, collect reward.
Outputs the per-step telemetry and cumulative decision time H = Σ d_t.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.controller import ControllerBase, Observation
from repro_torch.core.controller import decide as _decide
from repro_torch.core.mdp import ADAPTATION_INTERVAL, Config, Pipeline, QoSWeights
from repro_torch.core.policy import Policy, action_to_config, sample_action
from repro_torch.core.vecenv import env_generators, tables_from_pipeline, vec_rollout
from repro_torch.device import resolve_device


def _check_device(params: Policy, device: torch.device):
    have = next(params.parameters()).device
    if have.type != device.type:
        raise ValueError(f"policy parameters are on {have}, not on the "
                         f"requested device {device}")


class OPDPolicy(ControllerBase):
    """Deployable policy wrapper implementing the Controller protocol:
    ``decide(obs) -> Config``, measuring steady-state decision time. The
    policy ``params`` must already live on ``device``."""

    def __init__(self, pipe: Pipeline, params: Policy, *, greedy: bool = True,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        _check_device(params, self.device)
        self.pipe = pipe
        self.params = params
        self.greedy = greedy
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.decision_times: list[float] = []
        # warm the caches so measured decision time is steady-state
        self._warm = False

    def _act(self, state: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            a, _, _ = sample_action(self.params, state, self.gen, greedy=self.greedy)
        return a.cpu().numpy()

    def warmup(self, obs: Observation) -> None:
        """Run one throwaway forward pass, never timed; a sampling policy
        draws its noise from the generator, as the reference burns a key, so
        the key evolution is identical whether or not ``decide`` called it.
        Idempotent."""
        if self._warm:
            return
        self._act(torch.as_tensor(obs.state, device=self.device))
        self._warm = True

    def decide(self, obs: Observation) -> Config:
        s = torch.as_tensor(obs.state, device=self.device)
        self.warmup(obs)
        t0 = time.perf_counter()
        a = self._act(s)                # the action is on the host when the clock stops
        self.decision_times.append(time.perf_counter() - t0)
        return action_to_config(self.pipe, a)


def run_episodes_vectorized(pipe: Pipeline, params: Policy, traces, *, weights=None,
                            greedy: bool = True, seed: int = 0,
                            device="cuda") -> dict:
    """Batch policy evaluation on the analytic dynamics: one episode per
    trace row [B, seconds] via ``core.vecenv``, returning per-episode
    per-step arrays [B, T] (reward, qos, cost, latency, throughput, excess,
    demand) and the actions [B, T, 3N]. Greedy decode by default, so the
    result is deterministic in ``params`` and ``traces``; a sampling run
    draws env ``i``'s noise from a generator seeded with (seed, i)."""
    dev = resolve_device(device)
    _check_device(params, dev)
    traces = np.asarray(traces, np.float32)
    gens = None if greedy else env_generators(seed, range(len(traces)), dev)
    out = vec_rollout(params, tables_from_pipeline(pipe, device=dev),
                      torch.as_tensor(traces, device=dev), gens,
                      n_steps=traces.shape[1] // ADAPTATION_INTERVAL,
                      weights=weights or QoSWeights(), greedy=greedy)
    keep = ("rewards", "qos", "cost", "latency", "throughput", "excess",
            "demand", "actions")
    return {k: out[k].cpu().numpy() for k in keep}


def run_episode(env, policy) -> dict:
    """Run one workload cycle under ``policy`` (a Controller or any legacy
    (env)->Config callable). Returns per-step arrays: reward, qos, cost,
    latency, throughput, excess, and cumulative decision time H (if the
    policy records it)."""
    env.reset()
    if hasattr(policy, "decision_times"):
        # H must cover THIS episode only — a reused policy object would
        # otherwise report cumulative time across episodes
        policy.decision_times = []
    out = {k: [] for k in ("reward", "qos", "cost", "latency", "throughput",
                           "excess", "demand")}
    done = False
    while not done:
        cfg = _decide(policy, env)
        _, r, done, info = env.step(cfg)
        out["reward"].append(r)
        for k in ("qos", "cost", "latency", "throughput", "excess", "demand"):
            out[k].append(info[k])
    result = {k: np.asarray(v) for k, v in out.items()}
    if hasattr(policy, "decision_times"):
        result["decision_time_total"] = float(np.sum(policy.decision_times))
        result["decision_times"] = np.asarray(policy.decision_times)
    return result
