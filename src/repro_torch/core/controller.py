"""Public controller-facing interface.

A controller is anything implementing ``decide(obs: Observation) -> Config``.
``Observation`` is the *public* snapshot an environment hands the controller
each adaptation interval — the Eq. (5) state vector plus the live config and
the monitor's current/predicted load — so policies no longer reach into
``env._observe()`` / ``env._predicted_load()`` private APIs.

``ControllerBase`` keeps the legacy ``policy(env)`` call style working as a
back-compat shim (it builds the Observation via ``env.observe()``), and the
module-level ``decide(controller, env)`` helper lets entry points accept both new
protocol objects and bare ``(env) -> Config`` callables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.mdp import Config


@dataclass(frozen=True, eq=False)
class Observation:
    """What a controller may observe at decision time (public API)."""
    state: np.ndarray        # Eq. (5) feature vector, [n_tasks * 9]
    config: Config           # configuration currently live
    current_load: float      # newest monitored arrival rate (req/s)
    predicted_load: float    # predictor's load estimate for the next interval
    # multi-horizon forecasts (core/forecast.py), when the env carries a
    # forecaster: forecasts[k] = predicted max load over the next
    # horizons[k] seconds. None otherwise — absent, not zero, so policies
    # can distinguish "no forecaster" from "forecast of 0".
    forecasts: tuple[float, ...] | None = None
    horizons: tuple[int, ...] | None = None


@runtime_checkable
class Controller(Protocol):
    """Anything deciding a Config from a public Observation."""

    def decide(self, obs: Observation) -> Config: ...


class ControllerBase:
    """Base for controllers: implement ``decide``; ``__call__(env)`` is the
    back-compat shim for legacy ``policy(env)`` call sites."""

    def decide(self, obs: Observation) -> Config:
        raise NotImplementedError

    def __call__(self, env) -> Config:
        return self.decide(env.observe())


def decide(controller, env) -> Config:
    """Invoke ``controller`` on ``env``: prefer the Observation protocol,
    fall back to the legacy ``(env) -> Config`` callable style.

    Proactive controllers may additionally publish a ``prewarm_plan`` —
    ``[(stage, variant), ...]`` standby warm-ups to start this interval —
    which is forwarded to the env's live runtime when it has one
    (``RuntimeEnv``); the analytic env has no warm/cold machinery, so the
    plan is a no-op there."""
    if hasattr(controller, "decide"):
        cfg = controller.decide(env.observe())
        plan = getattr(controller, "prewarm_plan", None)
        runtime = getattr(env, "runtime", None)
        if plan and runtime is not None and hasattr(runtime, "prewarm"):
            for stage, variant in plan:
                runtime.prewarm(int(stage), int(variant))
        return cfg
    return controller(env)
