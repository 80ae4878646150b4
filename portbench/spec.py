"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A configuration is ``portbench/configs/<name>.json`` (the path is its ``file``),
a traffic mix ``portbench/traffic/<name>.json`` and a per-layer metric's reader
``portbench/metrics/<name>.py``. Adding a cell, a mix or a metric adds files and
entries; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return json.loads((Path(root) / entry["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "portbench" / "traffic" / f"{name}.json").read_text())


def metrics_for(bench: dict, section: str, workload: str) -> list[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
