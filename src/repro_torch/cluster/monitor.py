"""Prometheus-style monitoring daemon: ring-buffer time series of incoming
load and node/pipeline telemetry (paper §III-A "Monitoring")."""
from __future__ import annotations

from collections import deque

import numpy as np


class Monitor:
    def __init__(self, history: int = 120):
        self.history = history
        self.load = deque(maxlen=history)
        self.metrics = deque(maxlen=history)

    def record(self, load: float, **metrics):
        self.load.append(float(load))
        self.metrics.append(dict(metrics))

    @property
    def valid(self) -> int:
        """Number of *real* measurements in the window. ``load_history``
        left-pads a cold window with a constant — consumers that trained on
        real traces (predictor/forecaster) should fall back to the
        last-observed load until ``valid >= fn.min_history``."""
        return len(self.load)

    def load_history(self) -> np.ndarray:
        """Last ``history`` seconds of load, left-padded with the oldest value."""
        if not self.load:
            return np.zeros(self.history)
        arr = np.array(self.load, dtype=np.float64)
        if len(arr) < self.history:
            arr = np.concatenate([np.full(self.history - len(arr), arr[0]), arr])
        return arr

    def latest(self, key: str, default: float = 0.0) -> float:
        if not self.metrics:
            return default
        return float(self.metrics[-1].get(key, default))
