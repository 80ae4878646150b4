"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A configuration is ``portbench/configs/<name>.json`` (the path is its ``file``),
a traffic mix ``portbench/traffic/<name>.json``, a per-layer metric's reader
``portbench/metrics/<name>.py`` and an architecture's plain reference (its
parameter layout, forward and operation counts) ``portbench/archs/<module>.py``.
Adding a cell, a mix, a metric or an architecture adds files and entries; no
existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the reference module of an architecture that its configuration does not name
FAMILY_REFERENCE = {"dense": "decoder", "moe": "decoder", "vlm": "decoder", "audio": "whisper"}
CUTTABLE = ("n_layers", "vocab")  # the only sizes a configuration may cut, and say so
_ARCH_MODULES: dict = {}


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


def load_arch(module: str, root: Path = ROOT):
    """``portbench/archs/<module>.py`` of ``root``, loaded once; None if there
    is no such file. It defines ``layout(arch)``, ``logits(arch, seed, stage,
    variant, tokens, batch_rows, device, quant=None)``, ``forward_flops(arch,
    batch, seq)`` and ``flash_calls(arch, batch, seq)``."""
    path = (Path(root) / "portbench" / "archs" / f"{module}.py").resolve()
    if not path.is_file():
        return None
    if path not in _ARCH_MODULES:
        spec = importlib.util.spec_from_file_location(f"portbench_arch_{module}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ARCH_MODULES[path] = mod
    return _ARCH_MODULES[path]


def reference_module(arch: dict, config: dict | None = None, root: Path = ROOT):
    """The module that holds ``arch``'s plain reference: the one the
    configuration's ``reference`` names for it, else its family's (``decoder``
    for dense, moe and vlm without interleaved MoE or windowed attention,
    ``whisper`` for audio); None where there is none."""
    module = (config or {}).get("reference", {}).get(arch["name"])
    if module is None:
        module = FAMILY_REFERENCE.get(arch["family"])
        if module == "decoder" and not (arch.get("moe_every", 0) <= 1
                                        and arch.get("window") is None):
            module = None
    return None if module is None else load_arch(module, root)


def reference_for(arch: dict, config: dict | None = None, root: Path = ROOT):
    """``reference_module``, raising ValueError where none covers ``arch``."""
    mod = reference_module(arch, config, root)
    if mod is None:
        raise ValueError(f"no plain reference for {arch['name']} ({arch['family']})")
    return mod


def size_errors(config: dict, program_archs) -> list[str]:
    """How each architecture a stage names departs from the program's
    published one (``program_archs``, the program's ``ARCHS``, in the
    configuration's dtype). Only a cut the file states under ``cuts`` may
    differ: ``{arch: {key: published value}}``, a key of ``CUTTABLE`` that the
    file's ``reduced`` lists, the published value the program's own and the
    value held below it. Widths are never cut."""
    errors = []
    cuts = config.get("cuts", {})
    errors += [f"{n}: cut, but not an architecture of the file"
               for n in cuts if n not in config["archs"]]
    for name in dict.fromkeys(n for stage in config["stages"] for n in stage):
        if name not in program_archs:
            errors.append(f"{name}: not an architecture of the program")
            continue
        if name not in config["archs"]:
            errors.append(f"{name}: named by a stage but not in the file's archs")
            continue
        arch = config["archs"][name]
        want = json.loads(json.dumps(program_archs[name].replace(dtype=config["dtype"]).__dict__))
        for key, published in cuts.get(name, {}).items():
            if key not in CUTTABLE:
                errors.append(f"{name}: {key} may not be cut, only {', '.join(CUTTABLE)}")
            elif key not in config["reduced"]:
                errors.append(f"{name}: {key} is cut but not listed in reduced")
            elif want[key] != published:
                errors.append(f"{name}: {key} is published as {want[key]}, not {published}")
            elif not arch[key] < published:
                errors.append(f"{name}: {key} {arch[key]} is not below the published {published}")
            else:
                want[key] = arch[key]
        differ = sorted(k for k in want.keys() | arch.keys() if want.get(k) != arch.get(k))
        if differ:
            errors.append(f"{name}: differs from the program's published sizes in {differ}")
    return errors
