"""Proactive pre-warm control: amortize cold starts before a forecast burst.

The reactive loop (OPD or any baseline) only reacts *after* the load moves:
a burst at t means the controller upsizes at the next adaptation interval
and then pays ``COLD_START_SECONDS`` of stage unavailability exactly while
the queue is deepest — the cold start dominates p95/p99 on bursty traces
(``runtime_throughput.json``).

``ProactiveController`` wraps any inner Controller and uses the env's
multi-horizon forecasts (``Observation.forecasts``, from
``core/forecast.py``) to split the reaction in two:

1. *now* — keep serving the inner controller's configuration for the
   current predicted load (no behavior change on the serving path);
2. *ahead* — re-run the inner controller against the forecast burst load
   and, where the burst configuration uses a different variant, publish a
   ``prewarm_plan``. The ``decide()`` helper forwards the plan to
   ``ServingRuntime.prewarm``, which pays the cold start on a standby slot
   while the live variant keeps serving; when the burst arrives and the
   inner controller actually switches, ``apply_config`` finds the variant
   warm and the switch is (close to) free.

A burst is "worth pre-warming" when the max forecast across horizons
exceeds ``margin ×`` the next-interval prediction — under that threshold
the standby slot would churn on noise.

Port of ``repro/core/proactive.py``: plain Python and NumPy, so its plans
match the reference's bit for bit on the same observations.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.controller import ControllerBase, Observation
from repro_torch.core.mdp import Config

# Eq. (5) column holding the predicted load m (u, p, m, l, t, ...)
_M_COL = 2


class ProactiveController(ControllerBase):
    """Wrap ``inner`` with forecast-driven variant pre-warming.

    After each ``decide`` the freshly computed standby plan is available as
    ``prewarm_plan`` — ``[(stage, variant), ...]`` — consumed by the
    ``core.controller.decide`` helper. With no forecasts on the observation
    the wrapper is transparent (plan stays empty)."""

    def __init__(self, inner, *, margin: float = 1.15):
        self.inner = inner
        self.margin = float(margin)
        self.prewarm_plan: list[tuple[int, int]] = []
        self.planned = 0            # standby warm-ups published (telemetry)

    def warmup(self, obs: Observation) -> None:
        if hasattr(self.inner, "warmup"):
            self.inner.warmup(obs)

    def _burst_obs(self, obs: Observation, burst: float) -> Observation:
        """The same snapshot re-projected to the forecast burst: the
        predicted-load feature (column m of every Eq. 5 task row) and
        ``predicted_load`` are replaced by the burst load, so the inner
        controller answers "how would you configure *for the burst*?"."""
        n_tasks = len(obs.config.z)
        state = np.array(obs.state, dtype=np.float32).reshape(n_tasks, -1)
        state[:, _M_COL] = burst / 100.0
        return dataclasses.replace(obs, state=state.reshape(-1),
                                   predicted_load=float(burst))

    def decide(self, obs: Observation) -> Config:
        cfg = self.inner.decide(obs)
        self.prewarm_plan = []
        if obs.forecasts:
            burst = max(obs.forecasts)
            if burst > self.margin * max(obs.predicted_load, 1e-9):
                ahead = self.inner.decide(self._burst_obs(obs, burst))
                self.prewarm_plan = [
                    (i, int(ahead.z[i])) for i in range(len(cfg.z))
                    if ahead.z[i] != cfg.z[i]]
                self.planned += len(self.prewarm_plan)
        return cfg
