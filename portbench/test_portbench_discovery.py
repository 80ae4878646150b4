"""BENCHMARK.json against the benchmark's contract, and discovery by name: a
configuration, a traffic mix and a metric reader are files found by the
names BENCHMARK.json gives, so a later change adds files and edits none."""

import json
import re
import shutil

import pytest

from portbench import spec

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
        for name, arch in cfg["archs"].items():
            want = json.loads(json.dumps(ARCHS[name].replace(dtype=cfg["dtype"]).__dict__))
            assert arch == want, name


def test_new_files_are_found_without_editing(tmp_path):
    """A later change adds a cell, a mix and a metric as new files and
    entries: the lookups find them, and the existing files are untouched."""
    shutil.copytree(spec.HERE / "configs", tmp_path / "portbench" / "configs")
    shutil.copytree(spec.HERE / "traffic", tmp_path / "portbench" / "traffic")
    shutil.copytree(spec.HERE / "metrics", tmp_path / "portbench" / "metrics")
    before = {p.name: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    traffic = spec.load_traffic("steady_high.120")
    traffic.update(name="steady_high.60", rate=60)
    (tmp_path / "portbench" / "traffic" / "steady_high.60.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "stage0_batches.py").write_text(
        "def read(ctx):\n    return sum(1 for b in ctx['batches'] if b.stage == 0)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "serve3.steady60", "config": "serve3-bf16",
                               "traffic": "steady_high.60", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "stage0_batches", "unit": "batch", "better": "higher",
                               "source": "program_counter", "layer": "runtime batching",
                               "moves": "live_req_per_s", "workloads": ["serve3.steady60"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.load_benchmark(tmp_path)
    cell = spec.find_cell(loaded, "serve3.steady60")
    assert spec.load_traffic(cell["traffic"], tmp_path)["rate"] == 60
    assert spec.load_config(loaded, cell["config"], tmp_path)["name"] == "serve3-bf16"
    metrics = [m["name"] for m in spec.metrics_for(loaded, "per_layer", "serve3.steady60")]
    assert "stage0_batches" in metrics
    assert "stage0_batches" not in [
        m["name"] for m in spec.metrics_for(loaded, "per_layer", "edge4.steady120")]
    assert spec.load_reader("stage0_batches", tmp_path)({"batches": []}) == 0
    after = {p.name: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and p.name in before}
    assert after == before
