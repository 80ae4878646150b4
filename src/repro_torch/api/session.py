"""The Session facade — owns the env / runtime / predictor / policy
lifecycle that entry points used to wire by hand:

    sess = Session.from_spec(exp)     # ExperimentSpec, dict, or JSON str
    sess.train(log=print)             # PPO episodes (no-op for baselines)
    sess.serve(on_step=...)           # run the control loop over the horizon
    sess.report()                     # JSON-safe results incl. the spec

Port of ``repro/api/session.py``. Every random draw (arrival stream, request
tokens, policy sampling, PPO training) derives from the spec's seeds, so a
spec reloaded from JSON reproduces the run bit for bit; under a
non-learned controller the same spec gives the reference's rewards,
configs and summary. The OPD policy and a scenario's load forecaster train
and run on ``device`` (default ``"cuda"``), which is resolved when one is
first needed, so a non-learned controller without a forecaster never asks
for the card.

``real=True`` serves each stage through live PyTorch models: a
``StageServer`` per stage, built once per session on ``device`` (default
``"cuda"``, where attention runs through the hand-written Hopper kernels) at
the archs' full width, in ``dtype`` (default ``"float32"``; ``"bfloat16"``
halves the weights, so paper-4stage's eight archs fit one 80 GB card). The
dtype is a keyword of the session, not a spec field: the reference's specs
carry none, and the executors never move the virtual clock, so a real run's
virtual-time results equal those of ``real=False`` in any dtype.

``debug_checkify=True`` runs training and serving under the twins'
sanitizer (``analysis.sanitize``), as the reference's does.

``FleetSession`` serves N tenants on one shared event loop; its tenants'
learned controllers and forecasters train on the fleet session's device.
"""
from __future__ import annotations

import contextlib
import json
import time

import numpy as np

from repro_torch import tracing
from repro_torch.analysis import sanitize
from repro_torch.api.registry import controller_factory
from repro_torch.api.specs import ExperimentSpec, FleetSpec
from repro_torch.cluster.env import PipelineEnv, RuntimeEnv
from repro_torch.core.controller import decide
from repro_torch.core.ppo import OPDTrainer, PPOConfig
from repro_torch.device import resolve_device

# per-step scalar keys copied into the report (runtime adds percentiles etc.)
_STEP_KEYS = ("qos", "cost", "latency", "throughput", "excess", "demand")
_TRAINABLE = ("opd", "proactive")


def build_servers(spec: ExperimentSpec, *, device="cuda", smoke: bool = False,
                  dtype: str = "float32"):
    """One live ``StageServer`` per stage on ``device``, at full width, with
    weights and activations in ``dtype`` (``ArchConfig.dtype``).
    ``smoke=True`` builds the archs' reduced configs instead, as the
    reference's CPU executors do; only the CPU tests ask for it. The dtype
    is set after ``smoke()``, which resets it to float32."""
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import StageServer
    return [StageServer(f"stage{i}",
                        [(ARCHS[n].smoke() if smoke else ARCHS[n]).replace(dtype=dtype)
                         for n in names],
                        seq_len=spec.seq_len, seed=i, device=device)
            for i, names in enumerate(spec.pipeline.stages)]


def build_executors(spec: ExperimentSpec, *, device="cuda", smoke: bool = False,
                    dtype: str = "float32"):
    """Live PyTorch models as stage executors for ``real`` runs."""
    return [s.execute for s in build_servers(spec, device=device, smoke=smoke,
                                             dtype=dtype)]


class Session:
    def __init__(self, spec: ExperimentSpec, *, device="cuda", smoke: bool = False,
                 dtype: str = "float32", debug_checkify: bool = False):
        self.spec = spec
        self.pipe = spec.pipeline.build()
        self.device = device
        self.smoke = smoke
        self.dtype = dtype
        self.servers = None             # live StageServers of a real run
        self.trainer: OPDTrainer | None = None
        self.controller = None
        self._params = None
        self._forecaster = None         # trained once, shared across envs
        self._report: dict | None = None
        # debug toggle: run every twin rollout under the sanitizer (NaN /
        # integer division by zero / out-of-bounds index surface as a
        # SanitizerError instead of reward drift); also reachable via the
        # REPRO_CHECKIFY=1 env flag without touching call sites
        self.debug_checkify = debug_checkify

    def _sanitize_scope(self):
        return (sanitize.enabled_scope(True) if self.debug_checkify
                else contextlib.nullcontext())

    # ------------------------------------------------------------ creation --

    @classmethod
    def from_spec(cls, spec: ExperimentSpec | dict | str, *, device="cuda",
                  dtype: str = "float32", debug_checkify: bool = False) -> Session:
        if isinstance(spec, str):
            spec = json.loads(spec)
        if isinstance(spec, dict):
            spec = ExperimentSpec.from_dict(spec)
        return cls(spec, device=device, dtype=dtype, debug_checkify=debug_checkify)

    # ------------------------------------------------------------ training --

    @property
    def trainable(self) -> bool:
        return self.spec.controller.name in _TRAINABLE

    def train(self, episodes: int | None = None, *, log=None) -> Session:
        """Run PPO training for learned controllers; no-op for baselines.
        The controller's ``train_backend`` picks what on-policy episodes
        roll on, on the session's device: "analytic" steps the closed-form
        ``PipelineEnv`` (vectorized via ``num_envs``), "runtime" rolls
        closed-loop episodes on the discrete-event twin
        (``core.runtime_vec``); expert episodes always step a real env.
        Fully seeded from the spec."""
        c, scen = self.spec.controller, self.spec.scenario
        episodes = c.train_episodes if episodes is None else episodes
        if not self.trainable or episodes <= 0:
            return self
        runtime_backend = c.train_backend == "runtime"
        if c.train_backend not in ("analytic", "runtime"):
            raise ValueError(f"unknown train_backend {c.train_backend!r}")

        def make_env(seed):
            if runtime_backend:
                return RuntimeEnv(self.pipe, scen.train_arrivals(seed),
                                  horizon=scen.horizon)
            return PipelineEnv(self.pipe,
                               scen.train_trace(seed, seconds=c.train_seconds),
                               seed=seed)

        if self.trainer is None:
            self.trainer = OPDTrainer(
                self.pipe, make_env,
                ppo=PPOConfig(expert_freq=c.expert_freq), seed=c.seed,
                num_envs=c.num_envs,
                vec_runtime=scen.train_arrivals if runtime_backend else None,
                device=self.device)
        with self._sanitize_scope():
            for ep in range(1, episodes + 1):
                self.trainer.train_episode(ep, env_seed=ep)
                if log:
                    h = self.trainer.history
                    log(f"episode {ep}: reward={h['reward'][-1]:9.2f} "
                        f"loss={h['loss'][-1]:7.3f} expert={h['expert'][-1]}")
        self.controller = None          # params changed -> rebuild on serve
        return self

    def build_forecaster(self, *, log=None):
        """Train the scenario's named ``PredictorSpec`` (once per session,
        cached) on the scenario's *own arrival family* — per-second counts
        Poisson-sampled from ``train_trace`` episode rate profiles, so the
        model sees the integer-valued histories the Monitor will feed it,
        decorrelated from the eval stream — on the session's device.
        Returns an ``as_forecast_fn`` adapter, or None when the scenario
        names no predictor."""
        scen = self.spec.scenario
        if scen.predictor is None:
            return None
        if self._forecaster is None:
            from repro_torch.api.registry import get_predictor
            from repro_torch.core import forecast
            ps = get_predictor(scen.predictor)
            traces = []
            for ep in range(ps.train_episodes):
                rates = np.maximum(scen.train_trace(ep), 0.0)
                rng = np.random.default_rng(scen.seed + 104729 * (ep + 1))
                traces.append(rng.poisson(rates).astype(np.float32))
            scale = ps.scale or float(max(max(tr.max() for tr in traces), 1.0))
            params, ch_scales = forecast.train_forecaster(
                traces, backbone=ps.backbone, scale=scale,
                horizons=ps.horizons, history=ps.history, hidden=ps.hidden,
                dim=ps.dim, n_heads=ps.n_heads, epochs=ps.epochs,
                batch=ps.batch, lr=ps.lr, seed=ps.seed, log=log,
                device=self.device)
            self._forecaster = forecast.as_forecast_fn(
                params, scale=scale, backbone=ps.backbone,
                horizons=ps.horizons, history=ps.history,
                n_heads=ps.n_heads, channel_scales=ch_scales)
        return self._forecaster

    # ------------------------------------------------------------- serving --

    def stage_servers(self) -> list:
        """The live stage servers of a real run, built on first use and kept
        for the session's later serves (the same seeds give the same
        weights, so rebuilding would change nothing)."""
        if self.servers is None:
            self.servers = build_servers(self.spec, device=self.device,
                                         smoke=self.smoke, dtype=self.dtype)
        return self.servers

    def build_env(self):
        spec, scen = self.spec, self.spec.scenario
        forecaster = self.build_forecaster()
        if spec.backend == "analytic":
            return PipelineEnv(self.pipe, scen.eval_trace(), seed=scen.seed,
                               forecaster=forecaster)
        if spec.backend == "runtime":
            executors = ([s.execute for s in self.stage_servers()]
                         if spec.real else None)
            return RuntimeEnv(self.pipe, scen.build_arrivals(),
                              horizon=scen.horizon, executors=executors,
                              seq_len=spec.seq_len, forecaster=forecaster)
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
        cfg, info)`` is called after each adaptation interval. Each
        interval's decision and step are ``tracing`` spans; the report's
        ``decide_wall_s`` are the decisions' walls."""
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
        with self._sanitize_scope():
            while not done:
                step = len(rewards)
                with tracing.span("serve.decide", step=step) as sp:
                    cfg = decide(controller, env)
                decide_walls.append(sp.seconds)
                with tracing.span("serve.step", step=step):
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


class FleetSession:
    """The Session facade for a multi-tenant fleet: builds every tenant's
    pipeline on the shared cluster, trains learned tenant controllers via
    per-tenant sub-Sessions, then serves all tenants on one shared event
    loop (``serving.fleet.FleetRuntime``). Fully seeded from the spec. The
    sub-Sessions train and forecast on ``device``."""

    def __init__(self, spec: FleetSpec, *, device="cuda"):
        self.spec = spec
        self.device = device
        self.fleet = None
        self._params: dict[str, object] = {}    # tenant name -> trained params
        self._forecasters: dict[str, object] = {}  # tenant name -> forecaster
        self._report: dict | None = None

    @classmethod
    def from_spec(cls, spec: FleetSpec | dict | str, *,
                  device="cuda") -> FleetSession:
        if isinstance(spec, str):
            spec = json.loads(spec)
        if isinstance(spec, dict):
            spec = FleetSpec.from_dict(spec)
        return cls(spec, device=device)

    def train(self, *, log=None) -> FleetSession:
        """PPO-train every learned tenant controller on its own pipeline
        view (no-op for baseline tenants)."""
        for t in self.spec.tenants:
            if (t.controller.name in _TRAINABLE
                    and t.controller.train_episodes > 0
                    and t.name not in self._params):
                sub = Session(ExperimentSpec(
                    pipeline=self.spec.tenant_pipeline(t),
                    scenario=t.scenario, controller=t.controller,
                    seq_len=self.spec.seq_len), device=self.device)
                sub.train(log=log)
                self._params[t.name] = sub.trainer.params
        return self

    def build_fleet(self, *, horizon: int | None = None):
        from repro_torch.serving.fleet import build_fleet
        entries = []
        for t in self.spec.tenants:
            pipe = self.spec.tenant_pipeline(t).build()
            controller = controller_factory(t.controller.name)(
                t.controller, pipe, self._params.get(t.name))
            if t.scenario.predictor and t.name not in self._forecasters:
                # train the tenant's named forecaster on its own arrival
                # family (cached, so repeat build_fleet calls reuse it)
                sub = Session(ExperimentSpec(
                    pipeline=self.spec.tenant_pipeline(t),
                    scenario=t.scenario, controller=t.controller,
                    seq_len=self.spec.seq_len), device=self.device)
                self._forecasters[t.name] = sub.build_forecaster()
            entries.append({"name": t.name, "pipe": pipe,
                            "arrivals": t.scenario.build_arrivals(),
                            "controller": controller,
                            "priority": t.priority, "slo_p99": t.slo_p99,
                            "forecaster": self._forecasters.get(t.name)})
        return build_fleet(entries,
                           admission_limit=self.spec.admission_limit,
                           min_share=self.spec.min_share,
                           horizon=horizon or self.spec.horizon,
                           seq_len=self.spec.seq_len)

    def serve(self, *, horizon: int | None = None, on_step=None) -> dict:
        """Run the fleet control loop: one ``step_interval`` per adaptation
        interval over the horizon, then drain. ``on_step(fleet, interval)``
        is called after each interval with the per-tenant results."""
        from repro_torch.core.mdp import ADAPTATION_INTERVAL
        self.train()
        horizon = int(horizon or self.spec.horizon)
        self.fleet = self.build_fleet(horizon=horizon)
        n_steps = max(1, horizon // ADAPTATION_INTERVAL)
        rewards: dict[str, list[float]] = {t.name: []
                                           for t in self.spec.tenants}
        sheds: dict[str, list[int]] = {t.name: [] for t in self.spec.tenants}
        wall0 = time.perf_counter()
        for _ in range(n_steps):
            interval = self.fleet.step_interval()
            for name, info in interval.items():
                rewards[name].append(float(info["reward"]))
                sheds[name].append(int(info["shed"]))
            if on_step:
                on_step(self.fleet, interval)
        self.fleet.drain()
        wall = time.perf_counter() - wall0
        summary = self.fleet.summary()
        summary["fleet"]["events_per_s"] = (self.fleet.loop.events
                                            / max(wall, 1e-9))
        self._report = {
            "fleet_spec": self.spec.to_dict(),
            "serve_wall_s": wall,
            "rewards": rewards,
            "shed_per_interval": sheds,
            "summary": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in summary.items()},
        }
        return self._report

    def report(self) -> dict:
        if self._report is None:
            self.serve()
        return self._report
