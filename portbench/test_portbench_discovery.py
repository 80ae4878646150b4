"""BENCHMARK.json against the benchmark's contract, and discovery by name: a
configuration, a traffic mix, a metric reader and an architecture's reference
module are files found by the names BENCHMARK.json and the configuration
give, so a later change adds files and edits none; and the sizes a
configuration runs are the program's, but for the depth and vocabulary cuts
it states."""

import json
import re
import shutil

import pytest

from portbench import counts, spec, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    cfg = spec.load_config(BENCH, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    assert cfg["name"] == cell["config"] and traffic["name"] == cell["traffic"]
    for stage in cfg["stages"]:
        assert all(name in cfg["archs"] for name in stage)
    assert set(cfg["limits"]) <= set(cfg["archs"])


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(section):
    names = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH[section]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(spec.load_reader(m["name"]))
        assert set(m.get("workloads", names)) <= names
        if section == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        else:
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_config_sizes_are_the_programs():
    from repro_torch.configs import ARCHS

    for entry in BENCH["configs"]:
        cfg = spec.load_config(BENCH, entry["name"])
        assert entry["file"].startswith("portbench/configs/")
        assert entry["reduced"] == cfg["reduced"]
        assert spec.size_errors(cfg, ARCHS) == [], entry["name"]


def _cut(cfg, *, held=None, cuts=None, reduced=("n_layers",)):
    """serve3's file with starcoder2-3b (30 layers, vocabulary 49,152, width
    3,072) holding ``held`` and stating ``cuts``."""
    cfg["archs"]["starcoder2-3b"].update(held or {})
    cfg["cuts"] = {"starcoder2-3b": cuts or {}}
    cfg["reduced"] = cfg["reduced"] + list(reduced)


CUTS = {
    "depth stated": (dict(held={"n_layers": 10}, cuts={"n_layers": 30}), None),
    "vocabulary stated": (dict(held={"vocab": 6144}, cuts={"vocab": 49152},
                               reduced=("vocab",)), None),
    "width": (dict(held={"d_model": 2048}), "differs"),
    "width stated as a cut": (dict(held={"d_model": 2048}, cuts={"d_model": 3072},
                                   reduced=("d_model",)), "may not be cut"),
    "depth unstated": (dict(held={"n_layers": 10}), "differs"),
    "wrong published value": (dict(held={"n_layers": 10}, cuts={"n_layers": 32}),
                              "published as 30"),
    "cut not in reduced": (dict(held={"n_layers": 10}, cuts={"n_layers": 30}, reduced=()),
                           "not listed in reduced"),
    "held not below": (dict(held={"n_layers": 40}, cuts={"n_layers": 30}), "not below"),
}


@pytest.mark.parametrize("case", list(CUTS))
def test_only_a_stated_depth_or_vocabulary_cut_passes(case):
    from repro_torch.configs import ARCHS

    cfg = spec.load_config(BENCH, "serve3-bf16")
    kwargs, refused = CUTS[case]
    _cut(cfg, **kwargs)
    errors = spec.size_errors(cfg, ARCHS)
    if refused is None:
        assert errors == []
    else:
        assert errors and all(e.startswith("starcoder2-3b: ") for e in errors), errors
        assert any(refused in e for e in errors), errors


def test_an_architecture_the_program_lacks_is_refused():
    from repro_torch.configs import ARCHS

    cfg = spec.load_config(BENCH, "serve3-bf16")
    name = "no-such-architecture"  # a name no architecture of the program takes
    cfg["archs"][name] = {**cfg["archs"]["starcoder2-3b"], "name": name}
    cfg["stages"][1].append(name)
    assert spec.size_errors(cfg, ARCHS) == [f"{name}: not an architecture of the program"]


# a reference module a configuration names: decoder's, counting its calls
COUNTING = '''
from pathlib import Path

from portbench import counts, spec, weights

_base = spec.load_arch("decoder", Path(__file__).resolve().parents[2])
calls = {"layout": 0, "logits": 0}
forward_flops, flash_calls = _base.forward_flops, _base.flash_calls


def layout(arch):
    calls["layout"] += 1
    return _base.layout(arch)


def logits(*args, **kwargs):
    calls["logits"] += 1
    return _base.logits(*args, **kwargs)
'''


@pytest.mark.parametrize("module_file", [True, False], ids=["module", "no_module"])
def test_a_configuration_brings_its_own_reference_module(tmp_path, module_file):
    """A smoke run of serve3 whose file maps starcoder2-3b to ``counting``:
    with ``archs/counting.py`` beside it the harness fills the program's
    weights and checks its rows through that module; without it, the variant
    keeps the program's own weights and is counted unchecked."""
    from portbench import harness, smoke

    root = smoke.make_root(tmp_path, "serve3.steady240", limit=0.05, rate=3.0)
    path = root / "portbench" / "configs" / "serve3-bf16.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps({**cfg, "reference": {"starcoder2-3b": "counting"}}))
    if module_file:
        (root / "portbench" / "archs" / "counting.py").write_text(COUNTING)
    cell = harness.Cell("serve3.steady240", root=root, device="cpu", log=lambda msg: None)
    window = cell.run(2**31 + 91, 0.0)
    checks, _, details = cell.judge(window)
    assert checks["unchecked_variants"] == (0 if module_file else 1, 0)
    assert ("starcoder2-3b" in details) is module_file
    if module_file:
        calls = spec.load_arch("counting", root).calls
        assert calls["layout"] >= 1 and calls["logits"] == 1, calls
        assert harness.passes(checks), checks
    else:
        assert spec.load_arch("counting", root) is None and not harness.passes(checks)


def test_new_files_are_found_without_editing(tmp_path):
    """A later change adds a cell, a mix and a metric as new files and
    entries: the lookups find them, and the existing files are untouched."""
    for sub in ("configs", "traffic", "metrics", "archs"):
        shutil.copytree(spec.HERE / sub, tmp_path / "portbench" / sub)
    before = {p.name: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    traffic = spec.load_traffic("steady_high.120")
    traffic.update(name="steady_high.60", rate=60)
    (tmp_path / "portbench" / "traffic" / "steady_high.60.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "stage0_batches.py").write_text(
        "def read(ctx):\n    return sum(1 for b in ctx['batches'] if b.stage == 0)\n")
    # a configuration whose stage-1 architecture is cut in depth and has a
    # reference module of its own
    cfg = spec.load_config(BENCH, "serve3-bf16")
    _cut(cfg, held={"n_layers": 10}, cuts={"n_layers": 30})
    cfg.update(name="serve3-cut", reference={"starcoder2-3b": "counting"})
    (tmp_path / "portbench" / "configs" / "serve3-cut.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench" / "archs" / "counting.py").write_text(COUNTING)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "serve3-cut", "source": "test",
                             "file": "portbench/configs/serve3-cut.json",
                             "reduced": cfg["reduced"], "why": "test"})
    bench["workloads"].append({"name": "serve3.steady60", "config": "serve3-cut",
                               "traffic": "steady_high.60", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "stage0_batches", "unit": "batch", "better": "higher",
                               "source": "program_counter", "layer": "runtime batching",
                               "moves": "live_req_per_s", "workloads": ["serve3.steady60"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.load_benchmark(tmp_path)
    cell = spec.find_cell(loaded, "serve3.steady60")
    assert spec.load_traffic(cell["traffic"], tmp_path)["rate"] == 60
    from repro_torch.configs import ARCHS

    cut = spec.load_config(loaded, cell["config"], tmp_path)
    assert cut["name"] == "serve3-cut" and spec.size_errors(cut, ARCHS) == []
    coder = cut["archs"]["starcoder2-3b"]
    assert spec.reference_module(coder, cut, tmp_path) is spec.load_arch("counting", tmp_path)
    assert spec.reference_module(coder, cut, tmp_path) is not spec.reference_module(coder)
    ten_layers = [(32, 448, 24, 2, 128)] * 10
    assert counts.flash_calls(coder, 32, 448, cut, tmp_path) == ten_layers
    assert weights.layout(coder, cut, tmp_path) == weights.layout(coder)
    metrics = [m["name"] for m in spec.metrics_for(loaded, "per_layer", "serve3.steady60")]
    assert "stage0_batches" in metrics
    assert "stage0_batches" not in [
        m["name"] for m in spec.metrics_for(loaded, "per_layer", "edge4.steady120")]
    assert spec.load_reader("stage0_batches", tmp_path)({"batches": []}) == 0
    after = {p.name: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and p.name in before}
    assert after == before
