"""Edge-cell environments exposing the paper's MDP (state Eq. 5, action
Eq. 6, reward Eq. 7) as gym-style environments.

Two backends share the MDP plumbing (``_ConfigEnvBase``: observation layout,
default config, predictor hook):

- ``PipelineEnv`` — the analytic simulator: each step = one 10 s adaptation
  interval over a 1 Hz workload trace, physics from perf_model's roofline
  latency curves, cold starts charged as a capacity fraction.
- ``RuntimeEnv``  — the closed-loop adapter over the event-driven
  ``serving.runtime.ServingRuntime``: each step applies the action to the
  live runtime (variant switches pay cold start in *virtual time*), advances
  the event loop one adaptation interval, and scores *measured* telemetry
  (served throughput, end-to-end latency percentiles, queue backlog) with
  the same Eq. (3)/(7) formulas via ``score_measurements``. The predictor
  reads the runtime's per-second arrival history through the same Monitor.

NumPy and plain Python, as in ``repro/cluster/env.py``: observations and
rewards match the reference's bit for bit under the same actions. A
predictor or forecaster is any callable; the port's learned ones
(``core/predictor.py``, ``core/forecast.py``) run on their params' device
and hand back host values, once per observation.
"""
from __future__ import annotations

import numpy as np

from repro_torch import tracing
from repro_torch.cluster.monitor import Monitor
from repro_torch.core.controller import Observation
from repro_torch.core.mdp import (ADAPTATION_INTERVAL, COLD_START_FRACTION, Config,
                            Pipeline, QoSWeights, accuracy_and_cost,
                            analytic_pipeline_latency, evaluate, placement_for,
                            resource_usage, resources_feasible,
                            score_measurements)


class _ConfigEnvBase:
    """Shared MDP plumbing: Eq. (5) observation, default config, predictor."""

    pipe: Pipeline
    cfg: Config
    monitor: Monitor
    predictor = None                 # callable: load_hist -> predicted load
    forecaster = None                # callable: load_hist -> [H] max loads
    forecast_in_state = False        # append forecast block to Eq. 5 state

    @property
    def state_dim(self) -> int:
        # per task: (u, p, m, l, t, z, f, b, c)  — Eq. (5) — plus, on a
        # heterogeneous topology, one free-capacity fraction per node so the
        # feature extractor sees comprehensive node status, plus (opt-in via
        # ``forecast_in_state``) one predicted max load per forecast horizon
        return self.pipe.n_tasks * (9 + self._n_node_features
                                    + self._n_forecast_features)

    @property
    def _n_node_features(self) -> int:
        return 0 if self.pipe.scalar_pool else self.pipe.topo.n_nodes

    @property
    def _n_forecast_features(self) -> int:
        if self.forecaster is None or not self.forecast_in_state:
            return 0
        return len(self.forecaster.horizons)

    def _forecasts(self) -> np.ndarray | None:
        """Per-horizon predicted max loads ([H]), or None without a
        forecaster. Until the monitor holds a full window of *real*
        measurements the model would see constant left-padding it never
        trained on (``Monitor.valid``) — fall back to the last-observed
        load at every horizon."""
        fc = self.forecaster
        if fc is None:
            return None
        if self.monitor.valid < getattr(fc, "min_history", 0):
            return np.full(len(fc.horizons), self._current_load())
        return np.asarray(fc(self.monitor.load_history()), dtype=np.float64)

    def _at_horizon(self, fc: np.ndarray, horizon: float) -> float:
        """The forecast at the horizon nearest ``horizon`` seconds."""
        hs = self.forecaster.horizons
        return float(fc[int(np.argmin([abs(h - horizon) for h in hs]))])

    def predicted_load_at(self, horizon: float) -> float:
        """Horizon-matched predicted max load: the multi-horizon forecast
        nearest ``horizon`` s when a forecaster is attached, else the
        single-horizon predictor / current load."""
        fc = self._forecasts()
        if fc is None:
            return float(self._predicted_load())
        return self._at_horizon(fc, horizon)

    def _observe(self, cur: float | None = None,
                 pred: float | None = None,
                 fc: np.ndarray | None = None) -> np.ndarray:
        pipe, cfg = self.pipe, self.cfg
        u = (pipe.w_max - resource_usage(pipe, cfg)) / pipe.w_max
        p = (self._current_load() if cur is None else cur) / 100.0
        m = (self._predicted_load() if pred is None else pred) / 100.0
        if self._n_node_features:
            pl = placement_for(pipe, cfg)
            node_free = [(node.capacity - used) / node.capacity
                         for node, used in zip(pipe.topo.nodes,
                                               pl.node_usage,
                                               strict=True)]
        else:
            node_free = []
        if self._n_forecast_features:
            if fc is None:
                fc = self._forecasts()
            fc_feats = [float(v) / 100.0 for v in fc]
        else:
            fc_feats = []
        rows = []
        for n, task in enumerate(pipe.tasks):
            var = task.variants[cfg.z[n]]
            rows.append([
                u, p, m,
                var.latency(cfg.b[n]),                       # l_n
                var.throughput(cfg.b[n], cfg.f[n]) / 100.0,  # t_n
                cfg.z[n] / max(1, len(task.variants) - 1),
                cfg.f[n] / pipe.f_max,
                cfg.b[n] / pipe.b_max,
                cfg.f[n] * var.cost / pipe.w_max,            # c_n
            ] + node_free + fc_feats)
        return np.asarray(rows, dtype=np.float32).reshape(-1)

    def _current_load(self) -> float:
        raise NotImplementedError

    def _predicted_load(self) -> float:
        if self.predictor is not None:
            if self.monitor.valid >= getattr(self.predictor,
                                             "min_history", 0):
                return float(self.predictor(self.monitor.load_history()))
            return self._current_load()  # window still padded — see Monitor
        if self.forecaster is not None:
            fc = self._forecasts()
            return self._at_horizon(fc, ADAPTATION_INTERVAL)
        return self._current_load()

    def observe(self) -> Observation:
        """Public decision-time snapshot for the Controller protocol."""
        cur = float(self._current_load())
        fc = self._forecasts()                 # one forecaster call per obs
        if self.predictor is not None or fc is None:
            pred = float(self._predicted_load())
        else:
            pred = self._at_horizon(fc, ADAPTATION_INTERVAL)
        return Observation(
            state=self._observe(cur, pred, fc), config=self.cfg,
            current_load=cur, predicted_load=pred,
            forecasts=(None if fc is None
                       else tuple(float(v) for v in fc)),
            horizons=(None if self.forecaster is None
                      else tuple(self.forecaster.horizons)))

    def default_config(self) -> Config:
        N = self.pipe.n_tasks
        return Config(z=tuple(0 for _ in range(N)),
                      f=tuple(1 for _ in range(N)),
                      b=tuple(1 for _ in range(N)))


class PipelineEnv(_ConfigEnvBase):
    def __init__(self, pipe: Pipeline, trace: np.ndarray, *,
                 weights: QoSWeights | None = None, history: int = 120,
                 predictor=None, forecaster=None,
                 forecast_in_state: bool = False, seed: int = 0):
        self.pipe = pipe
        self.trace = np.asarray(trace, dtype=np.float64)
        self.w = weights or QoSWeights()
        self.monitor = Monitor(history)
        self.predictor = predictor           # callable: load_hist -> predicted
        self.forecaster = forecaster         # callable: load_hist -> [H]
        self.forecast_in_state = bool(forecast_in_state)
        self.rng = np.random.default_rng(seed)
        self.n_steps = len(self.trace) // ADAPTATION_INTERVAL
        self.reset()

    def _current_load(self) -> float:
        s = self.t * ADAPTATION_INTERVAL
        return float(self.trace[max(0, s - 1)])

    # ------------------------------------------------------------- api --

    def reset(self) -> np.ndarray:
        self.t = 0
        self.cfg = self.default_config()
        self.monitor = Monitor(self.monitor.history)
        for s in range(min(self.monitor.history, len(self.trace))):
            self.monitor.record(self.trace[s])
        return self._observe()

    def step(self, action: Config):
        """Apply ``action`` for the next adaptation interval."""
        prev = self.cfg
        self.cfg = action
        switched = np.array([action.z[n] != prev.z[n]
                             for n in range(self.pipe.n_tasks)])

        s0 = self.t * ADAPTATION_INTERVAL
        s1 = min(len(self.trace), s0 + ADAPTATION_INTERVAL)
        demand = float(np.mean(self.trace[s0:s1]))

        cold = (COLD_START_FRACTION * switched.sum() / self.pipe.n_tasks
                if switched.any() else 0.0)
        m = evaluate(self.pipe, action, demand, self.w, cold_frac=cold)
        r = m["reward"]
        infeasible = not resources_feasible(self.pipe, action)
        if infeasible:
            r -= 50.0

        for s in range(s0, s1):
            self.monitor.record(self.trace[s], qos=m["qos"], cost=m["C"],
                                latency=m["L"], throughput=m["T"],
                                excess=m["E"])

        self.t += 1
        done = self.t >= self.n_steps
        info = {"qos": m["qos"], "cost": m["C"], "latency": m["L"],
                "throughput": m["T"], "excess": m["E"], "demand": demand,
                "processed": m["T"], "capacity": m["capacity"],
                "infeasible": infeasible}
        return self._observe(), float(r), done, info


class RuntimeEnv(_ConfigEnvBase):
    """Closed-loop MDP over the live event-driven runtime.

    Arrivals are admitted up-front from an ``ArrivalProcess`` over
    ``horizon`` virtual seconds; each ``step(action)`` reconfigures the
    runtime (cold start paid in virtual time) and advances the event loop by
    one adaptation interval. Reward terms come from *measured* serving:
    T = completions/s in the interval, L = mean end-to-end latency of those
    completions, E = arrival rate − served rate (backlog growth).
    """

    def __init__(self, pipe: Pipeline, arrivals, *, horizon: int = 120,
                 weights: QoSWeights | None = None, history: int = 120,
                 predictor=None, forecaster=None,
                 forecast_in_state: bool = False,
                 executors: list | None = None,
                 max_wait: float | None = None, seq_len: int = 32,
                 vocab: int = 256, loop=None, rid_base: int = 0):
        # all stochasticity derives from arrivals.seed (arrival times and
        # request tokens) — the env itself is deterministic.  ``loop`` (a
        # serving.runtime.EventLoop) shares the event loop with other envs
        # (multi-tenant fleets; do not reset() a shared-loop env twice —
        # the superseded runtime's events would stay heaped); ``rid_base``
        # offsets request ids so tenants stay distinguishable in telemetry.
        from repro_torch.serving.runtime import DEFAULT_MAX_WAIT
        self.pipe = pipe
        self.arrivals = arrivals
        self.horizon = int(horizon)
        self.w = weights or QoSWeights()
        self.predictor = predictor
        self.forecaster = forecaster
        self.forecast_in_state = bool(forecast_in_state)
        self.executors = executors
        self.max_wait = DEFAULT_MAX_WAIT if max_wait is None else max_wait
        self.seq_len = seq_len
        self.vocab = vocab
        self._loop = loop
        self.rid_base = int(rid_base)
        self.monitor = Monitor(history)
        self.n_steps = max(1, self.horizon // ADAPTATION_INTERVAL)
        self.reset()

    def _current_load(self) -> float:
        return float(self.monitor.load_history()[-1])

    # ------------------------------------------------------------- api --

    def reset(self) -> np.ndarray:
        from repro_torch.serving.runtime import ServingRuntime
        self.t = 0
        self.cfg = self.default_config()
        self.runtime = ServingRuntime.from_pipeline(
            self.pipe, cfg=self.cfg, max_wait=self.max_wait,
            seq_len=self.seq_len, executors=self.executors, loop=self._loop)
        self.submitted = self.runtime.load(self.arrivals, self.horizon,
                                           vocab=self.vocab,
                                           rid_base=self.rid_base)
        # prefill the predictor's history with the t=0 expected rate — the
        # newest slot is what _current_load reads for the first observation
        self.monitor = Monitor(self.monitor.history)
        rate0 = float(self.arrivals.rates(1)[0])
        for _ in range(self.monitor.history):
            self.monitor.record(rate0)
        return self._observe()

    def begin_step(self, action: Config):
        """Apply ``action`` without advancing time. Returns the pending
        interval ``(t0, t1, switched, apply_wall_s)`` for ``finish_step``;
        ``apply_wall_s`` is the wall of the ``runtime.apply`` span.
        Split out so a fleet can reconfigure *every* tenant before the
        shared event loop advances any of them through the interval."""
        rt = self.runtime
        self.cfg = action
        t0 = rt.now
        t1 = t0 + ADAPTATION_INTERVAL
        with tracing.span("runtime.apply") as sp:
            switched = rt.apply_config(
                action, cold_start=COLD_START_FRACTION * ADAPTATION_INTERVAL)
        return t0, t1, switched, sp.seconds

    def finish_step(self, pending):
        """Score the interval opened by ``begin_step`` after the event loop
        has advanced past ``t1`` (scores ``self.cfg``)."""
        t0, t1, switched, apply_wall_s = pending
        rt, w, action = self.runtime, self.w, self.cfg

        tel = rt.telemetry
        arrived = tel.arrived_in(t0, t1)
        completed = tel.completed_in(t0, t1)
        demand = arrived / ADAPTATION_INTERVAL
        T = completed / ADAPTATION_INTERVAL
        lat = tel.latencies(t0, t1)
        if lat.size:
            L = float(lat.mean())
        else:
            # nothing finished this interval (cold start / deep queues):
            # charge the analytic stage latency so the penalty stays smooth
            L = analytic_pipeline_latency(self.pipe, action, max(demand, 1.0))
        E = demand - T
        V, C = accuracy_and_cost(self.pipe, action)
        m = score_measurements(V, C, T, L, E, w, max_batch=max(action.b))
        r = m["reward"]
        infeasible = not resources_feasible(self.pipe, action)
        if infeasible:
            r -= 50.0

        # measured per-second arrivals feed the predictor's load history
        for c in tel.load_history(t1, ADAPTATION_INTERVAL):
            self.monitor.record(float(c), qos=m["qos"], cost=m["C"],
                                latency=m["L"], throughput=m["T"],
                                excess=m["E"])

        self.t += 1
        done = self.t >= self.n_steps
        info = {"qos": m["qos"], "cost": m["C"], "latency": m["L"],
                "throughput": m["T"], "excess": m["E"], "demand": demand,
                "processed": completed, "infeasible": infeasible,
                "switched": switched, "migrations": rt.last_migrations,
                "apply_wall_s": apply_wall_s,
                "backlog": rt.in_system,
                "shed": tel.shed_in(t0, t1),
                "queue_depths": rt.queue_depths(),
                "node_utilization": rt.node_utilization(),
                **tel.latency_percentiles(t0=t0, t1=t1)}
        return self._observe(), float(r), done, info

    def step(self, action: Config):
        pending = self.begin_step(action)
        self.runtime.run_until(pending[1])
        return self.finish_step(pending)

    def drain(self) -> dict:
        """Finish all in-flight work after the last interval; final summary."""
        self.runtime.drain()
        return self.runtime.summary()
