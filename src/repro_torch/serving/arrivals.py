"""Pluggable arrival processes for the event-driven serving runtime.

Each process defines a per-second rate profile ``rates(horizon)`` (req/s)
and generates concrete arrival timestamps as a piecewise-homogeneous Poisson
process: for second ``s`` draw ``N ~ Poisson(rates[s])`` arrivals placed
uniformly inside ``[s, s+1)``. Deterministic per seed, so runtime runs are
reproducible and the environment can prefill the predictor's load history
with the expected-rate profile.
"""
from __future__ import annotations

import numpy as np


class ArrivalProcess:
    """Base: subclasses implement ``rates(horizon) -> [horizon] req/s``.

    Every process is a reproducible artifact: ``to_dict()`` captures its
    full parameterisation (JSON-safe) and ``from_dict`` rebuilds it, so a
    serialized experiment spec regenerates the identical arrival stream.
    """

    def __init__(self, *, seed: int = 0):
        self.seed = seed
        self._times_cache: dict[float, np.ndarray] = {}

    def rates(self, horizon: int) -> np.ndarray:
        raise NotImplementedError

    # ------------------------------------------------------ spec plumbing --
    _spec_fields: tuple[str, ...] = ()

    def to_dict(self) -> dict:
        out = {"kind": type(self).__name__, "seed": self.seed}
        for f in self._spec_fields:
            v = getattr(self, f)
            out[f] = v.tolist() if isinstance(v, np.ndarray) else v
        return out

    def times(self, horizon: float) -> np.ndarray:
        """The full event-time array for this process over [0, horizon):
        sorted arrival timestamps (virtual seconds), generated once and
        cached, so the Python event loop and the jitted runtime twin consume
        *identical* arrivals. The returned array is read-only — it is shared
        between callers.

        Generation is fully vectorized: all per-second Poisson counts in one
        draw, all uniform offsets in a second, instead of the historical
        per-second Python loop."""
        key = float(horizon)
        out = self._times_cache.get(key)
        if out is None:
            rng = np.random.default_rng(self.seed)
            seconds = int(np.ceil(horizon))
            lam = np.clip(np.asarray(self.rates(seconds), np.float64),
                          0.0, None)
            counts = rng.poisson(lam)
            total = int(counts.sum())
            if total == 0:
                out = np.empty(0, dtype=np.float64)
            else:
                base = np.repeat(np.arange(seconds, dtype=np.float64), counts)
                out = np.sort(base + rng.random(total))
                out = out[out < horizon]
            out.flags.writeable = False
            self._times_cache[key] = out
        return out

    def generate(self, horizon: float) -> np.ndarray:
        """Sorted arrival timestamps (virtual seconds) in [0, horizon)."""
        return self.times(horizon)


class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process at ``rate`` req/s."""

    _spec_fields = ("rate",)

    def __init__(self, rate: float, *, seed: int = 0):
        super().__init__(seed=seed)
        self.rate = float(rate)

    def rates(self, horizon: int) -> np.ndarray:
        return np.full(horizon, self.rate)


class TraceArrivals(ArrivalProcess):
    """Trace-driven: per-second rates from a workload trace (req/s), e.g.
    ``cluster.workloads.make_trace``. The trace tiles if shorter than the
    horizon."""

    _spec_fields = ("trace",)

    def __init__(self, trace: np.ndarray, *, seed: int = 0):
        super().__init__(seed=seed)
        self.trace = np.asarray(trace, dtype=np.float64)

    def rates(self, horizon: int) -> np.ndarray:
        reps = int(np.ceil(horizon / len(self.trace)))
        return np.tile(self.trace, reps)[:horizon]


class BurstyArrivals(ArrivalProcess):
    """Diurnal sinusoid around ``base_rate`` with deterministic square bursts
    to ``burst_rate`` every ``period`` seconds for ``burst_len`` seconds —
    the adversarial pattern for a fixed provisioning policy."""

    _spec_fields = ("base_rate", "burst_rate", "period", "burst_len",
                    "diurnal_period")

    def __init__(self, base_rate: float, burst_rate: float, *,
                 period: float = 60.0, burst_len: float = 10.0,
                 diurnal_period: float = 300.0, seed: int = 0):
        super().__init__(seed=seed)
        self.base_rate = float(base_rate)
        self.burst_rate = float(burst_rate)
        self.period = float(period)
        self.burst_len = float(burst_len)
        self.diurnal_period = float(diurnal_period)

    def rates(self, horizon: int) -> np.ndarray:
        t = np.arange(horizon, dtype=np.float64)
        lam = self.base_rate * (1.0 + 0.25 * np.sin(
            2 * np.pi * t / self.diurnal_period))
        in_burst = (t % self.period) < self.burst_len
        lam[in_burst] = self.burst_rate
        return lam


class RampArrivals(ArrivalProcess):
    """Linear ramp from ``start_rate`` to ``end_rate`` over the horizon —
    exercises the controller's scale-up path."""

    _spec_fields = ("start_rate", "end_rate")

    def __init__(self, start_rate: float, end_rate: float, *, seed: int = 0):
        super().__init__(seed=seed)
        self.start_rate = float(start_rate)
        self.end_rate = float(end_rate)

    def rates(self, horizon: int) -> np.ndarray:
        return np.linspace(self.start_rate, self.end_rate, max(horizon, 1))


SCENARIOS = ("bursty", "poisson", "ramp", "trace")

_PROCESS_KINDS = {cls.__name__: cls for cls in
                  (PoissonArrivals, TraceArrivals, BurstyArrivals,
                   RampArrivals)}


def arrivals_from_dict(d: dict) -> ArrivalProcess:
    """Rebuild an ArrivalProcess from ``process.to_dict()`` output; the
    constructor kwargs come from each class's own ``_spec_fields``."""
    cls = _PROCESS_KINDS[d["kind"]]
    kwargs = {f: d[f] for f in cls._spec_fields}
    if "trace" in kwargs:
        kwargs["trace"] = np.asarray(kwargs["trace"], dtype=np.float64)
    return cls(**kwargs, seed=d.get("seed", 0))


def make_arrivals(scenario: str, *, rate: float = 25.0, seed: int = 0,
                  trace: np.ndarray | None = None) -> ArrivalProcess:
    """The named scenarios every entry point (example, launcher, benchmark)
    shares, scaled around ``rate`` req/s. ``trace`` overrides the default
    fluctuating workload trace for the "trace" scenario."""
    if scenario == "poisson":
        return PoissonArrivals(rate, seed=seed)
    if scenario == "bursty":
        return BurstyArrivals(0.6 * rate, 1.8 * rate, period=60,
                              burst_len=10, seed=seed)
    if scenario == "ramp":
        return RampArrivals(0.2 * rate, 2.4 * rate, seed=seed)
    if scenario == "trace":
        if trace is None:
            # default fluctuating trace scaled so it peaks near ``rate`` —
            # the knob must act on every scenario, not silently no-op here
            from repro_torch.cluster.workloads import make_trace
            trace = make_trace("fluctuating", seed=seed, peak=2.0 * rate) / 2.0
        return TraceArrivals(trace, seed=seed)
    raise ValueError(f"unknown arrival scenario {scenario!r}")
