"""The Session facade — owns the env / runtime / policy lifecycle that entry
points used to wire by hand:

    sess = Session.from_spec(exp)     # ExperimentSpec, dict, or JSON str
    sess.train(log=print)             # PPO episodes (no-op for baselines)
    sess.serve(on_step=...)           # run the control loop over the horizon
    sess.report()                     # JSON-safe results incl. the spec

Port of ``repro/api/session.py``. Every random draw (arrival stream, request
tokens, policy sampling, PPO training) derives from the spec's seeds, so a
spec reloaded from JSON reproduces the run bit for bit; under a
non-learned controller the same spec gives the reference's rewards,
configs and summary. The OPD policy trains and decides on ``device``
(default ``"cuda"``), which is resolved when a policy is first needed, so a
non-learned controller never asks for the card.

``real=True`` serves each stage through live PyTorch models: a
``StageServer`` per stage, built once per session on ``device`` (default
``"cuda"``, where attention runs through the hand-written Hopper kernels) at
the archs' full width. The executors never move the virtual clock, so a real
run's virtual-time results equal those of ``real=False``.

Not ported yet, and raising rather than running something else: training
on the runtime twin (``train_backend="runtime"``, ROADMAP Queue 1 item 8),
a scenario's forecaster and the proactive controllers (item 9), the fleet
session (item 10), ``debug_checkify`` (item 13) and live stages of a family
without model code (item 11).
"""
from __future__ import annotations

import json
import time

import numpy as np

from repro_torch.api.registry import controller_factory
from repro_torch.api.specs import ExperimentSpec
from repro_torch.cluster.env import PipelineEnv, RuntimeEnv
from repro_torch.core.controller import decide
from repro_torch.core.ppo import OPDTrainer, PPOConfig
from repro_torch.device import resolve_device

# per-step scalar keys copied into the report (runtime adds percentiles etc.)
_STEP_KEYS = ("qos", "cost", "latency", "throughput", "excess", "demand")
_TRAINABLE = ("opd", "proactive")


def build_servers(spec: ExperimentSpec, *, device="cuda", smoke: bool = False):
    """One live ``StageServer`` per stage on ``device``, at full width.
    ``smoke=True`` builds the archs' reduced configs instead, as the
    reference's CPU executors do; only the CPU tests ask for it. A stage
    whose family has no model code in the port raises before any model is
    built: it is never skipped or served analytically instead."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.api import PORTED_FAMILIES
    from repro_torch.serving.engine import StageServer
    for i, names in enumerate(spec.pipeline.stages):
        for name in names:
            family = ARCHS[name].family
            if family not in PORTED_FAMILIES:
                raise NotImplementedError(
                    f"pipeline {spec.pipeline.name!r} stage {i}: arch {name!r} "
                    f"(family {family!r}) has no model code in the port yet, so "
                    "real=True cannot serve it (ROADMAP Queue 1 item 11, "
                    "remaining model families)")
    return [StageServer(f"stage{i}",
                        [ARCHS[n].smoke() if smoke else ARCHS[n] for n in names],
                        seq_len=spec.seq_len, seed=i, device=device)
            for i, names in enumerate(spec.pipeline.stages)]


def build_executors(spec: ExperimentSpec, *, device="cuda", smoke: bool = False):
    """Live PyTorch models as stage executors for ``real`` runs."""
    return [s.execute for s in build_servers(spec, device=device, smoke=smoke)]


class Session:
    def __init__(self, spec: ExperimentSpec, *, device="cuda", smoke: bool = False,
                 debug_checkify: bool = False):
        if debug_checkify:
            raise NotImplementedError(
                "debug_checkify: the port has no sanitizer for its twins yet "
                "(ROADMAP Queue 1 item 13, analysis + benchmarks)")
        self.spec = spec
        self.pipe = spec.pipeline.build()
        self.device = device
        self.smoke = smoke
        self.servers = None             # live StageServers of a real run
        self.trainer: OPDTrainer | None = None
        self.controller = None
        self._params = None
        self._report: dict | None = None

    # ------------------------------------------------------------ creation --

    @classmethod
    def from_spec(cls, spec: ExperimentSpec | dict | str, *,
                  device="cuda") -> Session:
        if isinstance(spec, str):
            spec = json.loads(spec)
        if isinstance(spec, dict):
            spec = ExperimentSpec.from_dict(spec)
        return cls(spec, device=device)

    # ------------------------------------------------------------ training --

    @property
    def trainable(self) -> bool:
        return self.spec.controller.name in _TRAINABLE

    def train(self, episodes: int | None = None, *, log=None) -> Session:
        """Run PPO training for learned controllers; no-op for baselines.
        On-policy episodes step the closed-form ``PipelineEnv``, vectorized
        on the session's device via ``num_envs``; expert episodes always step
        a real env. Fully seeded from the spec."""
        c, scen = self.spec.controller, self.spec.scenario
        episodes = c.train_episodes if episodes is None else episodes
        if not self.trainable or episodes <= 0:
            return self
        if c.name == "proactive":
            raise NotImplementedError(
                "controller 'proactive' wraps the OPD policy in a forecast-driven "
                "ProactiveController, not ported yet (ROADMAP Queue 1 item 9, "
                "forecasting + proactive control)")
        runtime_backend = c.train_backend == "runtime"
        if c.train_backend not in ("analytic", "runtime"):
            raise ValueError(f"unknown train_backend {c.train_backend!r}")

        def make_env(seed):
            return PipelineEnv(self.pipe,
                               scen.train_trace(seed, seconds=c.train_seconds),
                               seed=seed)

        if self.trainer is None:
            # the runtime backend's twin is not ported: the trainer raises
            self.trainer = OPDTrainer(
                self.pipe, make_env,
                ppo=PPOConfig(expert_freq=c.expert_freq), seed=c.seed,
                num_envs=c.num_envs,
                vec_runtime=scen.train_arrivals if runtime_backend else None,
                device=self.device)
        for ep in range(1, episodes + 1):
            self.trainer.train_episode(ep, env_seed=ep)
            if log:
                h = self.trainer.history
                log(f"episode {ep}: reward={h['reward'][-1]:9.2f} "
                    f"loss={h['loss'][-1]:7.3f} expert={h['expert'][-1]}")
        self.controller = None          # params changed -> rebuild on serve
        return self

    # ------------------------------------------------------------- serving --

    def stage_servers(self) -> list:
        """The live stage servers of a real run, built on first use and kept
        for the session's later serves (the same seeds give the same
        weights, so rebuilding would change nothing)."""
        if self.servers is None:
            self.servers = build_servers(self.spec, device=self.device,
                                         smoke=self.smoke)
        return self.servers

    def build_env(self):
        spec, scen = self.spec, self.spec.scenario
        if scen.predictor is not None:
            raise NotImplementedError(
                f"scenario predictor {scen.predictor!r}: forecasters are not "
                "ported yet (ROADMAP Queue 1 item 9)")
        if spec.backend == "analytic":
            return PipelineEnv(self.pipe, scen.eval_trace(), seed=scen.seed)
        if spec.backend == "runtime":
            executors = ([s.execute for s in self.stage_servers()]
                         if spec.real else None)
            return RuntimeEnv(self.pipe, scen.build_arrivals(),
                              horizon=scen.horizon, executors=executors,
                              seq_len=spec.seq_len)
        raise ValueError(f"unknown backend {spec.backend!r}")

    def with_params(self, params) -> Session:
        """Attach pre-trained policy params (a ``Policy`` on the session's
        device; skips in-session training) — lets callers share one trained
        agent across many sessions."""
        self._params = params
        self.controller = None
        return self

    def build_controller(self):
        c = self.spec.controller
        params = self._params
        if self.trainable and params is None:
            if self.trainer is None:
                self.train()
            if self.trainer is None:
                raise RuntimeError(
                    f"controller {c.name!r} needs training; set "
                    f"train_episodes > 0 or call session.train(episodes)")
            params = self.trainer.params
        if params is not None:
            want = resolve_device(self.device)
            have = next(params.parameters()).device
            if have.type != want.type:
                raise ValueError(f"policy parameters are on {have}, the session "
                                 f"runs on {want}")
        return controller_factory(c.name)(c, self.pipe, params)

    def serve(self, *, on_step=None) -> dict:
        """Run the control loop over the scenario horizon. ``on_step(env,
        cfg, info)`` is called after each adaptation interval."""
        env = self.build_env()
        if self.controller is None:
            self.controller = self.build_controller()
        controller = self.controller
        if hasattr(controller, "warmup"):
            # first-call costs happen outside the timed loop, so decide_wall_s
            # and decision_times agree from the first decision on
            controller.warmup(env.observe())
        if hasattr(controller, "decision_times"):
            controller.decision_times = []
        # build_env() returns a freshly reset env — no second reset needed
        steps: dict[str, list] = {k: [] for k in _STEP_KEYS}
        rewards, configs, decide_walls = [], [], []
        wall0 = time.perf_counter()
        done = False
        while not done:
            t0 = time.perf_counter()
            cfg = decide(controller, env)
            decide_walls.append(time.perf_counter() - t0)
            _, r, done, info = env.step(cfg)
            rewards.append(float(r))
            configs.append([list(cfg.z), list(cfg.f), list(cfg.b)])
            for k in _STEP_KEYS:
                steps[k].append(float(info[k]))
            if on_step:
                on_step(env, cfg, info)
        summary = env.drain() if hasattr(env, "drain") else {}
        if hasattr(env, "runtime"):
            summary["submitted"] = env.submitted
            summary["switches"] = env.runtime.switch_count
            summary["utilization"] = env.runtime.utilization()
            summary["virtual_now"] = env.runtime.now
        self._report = {
            "experiment": self.spec.to_dict(),
            # params injected via with_params() are not derivable from the
            # spec — flag it so nobody mistakes this report for spec-reproducible
            "external_params": self._params is not None,
            "rewards": rewards,
            "configs": configs,
            "decide_wall_s": decide_walls,
            "serve_wall_s": time.perf_counter() - wall0,
            "summary": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in summary.items()},
            **{k: v for k, v in steps.items()},
        }
        if hasattr(controller, "decision_times"):
            self._report["decision_times"] = list(controller.decision_times)
            self._report["decision_time_total"] = float(
                np.sum(controller.decision_times))
        return self._report

    # -------------------------------------------------------------- report --

    def report(self) -> dict:
        """JSON-safe results of the last serve (run on demand if it has not
        happened yet; serve trains lazily when the controller needs it)."""
        if self._report is None:
            self.serve()
        return self._report


def run_experiment(spec: ExperimentSpec | dict | str, *, log=None,
                   on_step=None, device="cuda") -> dict:
    """One-shot convenience: Session.from_spec -> train -> serve -> report."""
    sess = Session.from_spec(spec, device=device)
    sess.train(log=log)
    sess.serve(on_step=on_step)
    return sess.report()
