"""Perf-model calibration: fit measured stage latencies back into the
analytic model's ``(alpha, beta)`` parameters (port of
``repro/cluster/calibration.py``; NumPy, bit for bit the reference's).

``cluster/perf_model.py`` derives every ModelVariant's latency curve
``latency(b) = alpha + beta*b`` from architecture arithmetic against TPU
v5e constants. ``StageExecutor`` (``cluster/executor.py``) measures the
real curve on the card; this module least-squares-fits those measurements
per variant and per device class into a ``CalibrationTable``, then rebinds
a built ``Pipeline`` onto the fitted coefficients (``calibrate_pipeline``)
and a ``ClusterSpec``'s node speeds onto measured device-class factors
(``apply_to_cluster``).

``core.mdp.pipeline_metrics`` — and so both envs, the vectorized env and
the serving runtime — reads latency only through ``variant.alpha`` /
``variant.beta``, so swapping the coefficients here carries measured
physics through the whole control stack. ``PipelineSpec(perf_source=
"calibrated", calibration=<name-or-path>)`` is the user-facing switch.

One departure from the reference: ``resolve_table(None)`` raises instead of
loading the JAX package's committed table, which was measured on a 2-device
CPU mesh and describes no GPU. ``python -m repro_torch.launch.calibrate``
measures an H100 table.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.core.mdp import Pipeline, Task


def fit_alpha_beta(batches, latencies) -> tuple[float, float]:
    """Least-squares fit of ``latency(b) = alpha + beta*b`` from measured
    points, clamped to the model's physical domain (alpha, beta >= 0).

    A single measured point yields ``(latency, 0.0)`` — a flat curve is the
    honest reading of one sample.
    """
    b = np.asarray(batches, dtype=np.float64)
    y = np.asarray(latencies, dtype=np.float64)
    if b.shape != y.shape or b.ndim != 1 or b.size == 0:
        raise ValueError("batches and latencies must be equal-length 1-D")
    if b.size == 1 or np.all(b == b[0]):
        return float(max(y.mean(), 0.0)), 0.0
    beta, alpha = np.polyfit(b, y, 1)
    return float(max(alpha, 0.0)), float(max(beta, 0.0))


def predict(alpha: float, beta: float, batches) -> np.ndarray:
    return alpha + beta * np.asarray(batches, dtype=np.float64)


def mean_relative_error(pred, measured) -> float:
    pred = np.asarray(pred, dtype=np.float64)
    measured = np.asarray(measured, dtype=np.float64)
    return float(np.mean(np.abs(pred - measured) / measured))


@dataclass(frozen=True)
class CalibrationTable:
    """Measured ``(alpha, beta)`` per variant plus device-class speed
    factors — the JSON-round-trip artifact ``launch/calibrate.py`` emits and
    ``PipelineSpec(perf_source="calibrated")`` consumes.

    ``variants`` keys are ModelVariant names (``"<arch>:<quant>"``);
    ``speeds`` maps measured device-class labels (``StageExecutor.
    device_class``) to relative service-rate factors.
    """
    device_class: str
    variants: dict[str, tuple[float, float]]
    speeds: dict[str, float] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @classmethod
    def from_timings(cls, timings, *, speeds: dict | None = None,
                     meta: dict | None = None) -> CalibrationTable:
        """Group executor ``StageTiming``s by variant and fit each measured
        ``latency(b)`` curve. All timings must come from one device class."""
        classes = {t.device_class for t in timings}
        if len(classes) != 1:
            raise ValueError(f"timings span device classes {sorted(classes)};"
                             " fit one table per class")
        curves: dict[str, tuple[list, list]] = {}
        for t in timings:
            bs, ys = curves.setdefault(f"{t.arch}:{t.quant}", ([], []))
            bs.append(t.batch)
            ys.append(t.latency_s)
        variants = {name: fit_alpha_beta(bs, ys)
                    for name, (bs, ys) in sorted(curves.items())}
        return cls(device_class=classes.pop(), variants=variants,
                   speeds=dict(speeds or {}), meta=dict(meta or {}))

    def to_dict(self) -> dict:
        return {"device_class": self.device_class,
                "variants": {k: list(v) for k, v in self.variants.items()},
                "speeds": dict(self.speeds), "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: dict) -> CalibrationTable:
        return cls(device_class=str(d["device_class"]),
                   variants={k: (float(v[0]), float(v[1]))
                             for k, v in d["variants"].items()},
                   speeds={k: float(v)
                           for k, v in d.get("speeds", {}).items()},
                   meta=dict(d.get("meta", {})))

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2) + "\n")

    @classmethod
    def load(cls, path) -> CalibrationTable:
        payload = json.loads(Path(path).read_text())
        # calibration payloads embed the table under "table"
        return cls.from_dict(payload.get("table", payload))


def calibrate_pipeline(pipe: Pipeline, table: CalibrationTable) -> Pipeline:
    """The same Pipeline with every variant the table covers rebound onto
    its measured ``(alpha, beta)``; uncovered variants keep their analytic
    coefficients (a partial sweep calibrates what it measured)."""
    tasks = []
    for task in pipe.tasks:
        variants = tuple(
            dataclasses.replace(v, alpha=table.variants[v.name][0],
                                beta=table.variants[v.name][1])
            if v.name in table.variants else v
            for v in task.variants)
        tasks.append(Task(name=task.name, variants=variants))
    return dataclasses.replace(pipe, tasks=tuple(tasks))


def coverage(pipe: Pipeline, table: CalibrationTable) -> tuple[int, int]:
    """(variants of ``pipe`` the table covers, variants of ``pipe``)."""
    names = [v.name for t in pipe.tasks for v in t.variants]
    return sum(n in table.variants for n in names), len(names)


def apply_to_cluster(cluster, table: CalibrationTable, class_map: dict):
    """A ClusterSpec with node speed factors replaced by measured ones.

    ``class_map`` maps each ``NodeSpec.device_class`` (e.g. ``"edge-box"``)
    to a measured label in ``table.speeds`` (e.g. ``"cuda1"``); unmapped
    classes keep their declared speed.
    """
    nodes = tuple(
        dataclasses.replace(n, speed=float(table.speeds[class_map[n.device_class]]))
        if n.device_class in class_map else n
        for n in cluster.nodes)
    return dataclasses.replace(cluster, nodes=nodes)


# --------------------------------------------------------------- registry --

_TABLES: dict[str, CalibrationTable] = {}


def register_table(name: str, table: CalibrationTable) -> CalibrationTable:
    _TABLES[name] = table
    return table


def resolve_table(ref: str | None = None) -> CalibrationTable:
    """A calibration reference -> table: a ``register_table`` name or a JSON
    path (a raw table or a calibration payload). None raises: the port has
    no default table, and the reference's default describes a CPU mesh."""
    if ref is None:
        raise KeyError(
            "no calibration table named: the port has no default table (the "
            "JAX package's default was measured on a 2-device CPU mesh). "
            "Measure one on the card with `python -m repro_torch.launch.calibrate "
            "--out <dir>` and pass its table.json path, or register_table() "
            f"one (registered: {sorted(_TABLES)})")
    if ref in _TABLES:
        return _TABLES[ref]
    path = Path(ref)
    if path.exists():
        return CalibrationTable.load(path)
    raise KeyError(
        f"unknown calibration table {ref!r}: not a registered name and not "
        f"a JSON file (registered: {sorted(_TABLES)})")
