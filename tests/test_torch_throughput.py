"""The port's throughput launchers (``repro_torch.launch.{telemetry_queries,
runtime_throughput,fleet_throughput,train_throughput,roofline,run}``) vs the
reference's ``benchmarks.*``, on the CPU.

Both packages write under ``tmp_path`` (``benchmarks.common.set_results_dir``
and ``bench.set_results_dir``); nothing is written to ``experiments/``.

Tolerances:
- telemetry_queries, runtime_throughput, fleet_throughput at ``quick`` in
  both packages, and runtime_throughput at full size: every virtual-time
  field of the payloads equal bit for bit (the wall fields dropped), and the
  same row names; the committed H100 runtime_throughput.json repeats on the
  CPU in those fields;
- train_throughput at ``quick`` (port only): payload keys equal the
  committed ``experiments/results/train_throughput.json``'s, apart from the
  renames its docstring lists, and ``benchmarks/gate.py`` reads it;
- roofline over dry-run records this test counts (``launch/dryrun.count``
  on smoke configs: OK, DOES_NOT_FIT, SKIP, one OK given a ``measured``
  block): order, the ``None`` collective term, the measured columns and the
  markdown; the reference's collector raises on these records;
- ``launch/run.py --only`` runs one cheap suite and refuses an unknown name;
  every launcher raises on ``device="cuda"`` without a card.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import benchmarks.common as jcommon  # noqa: E402
import benchmarks.fleet_throughput as jfleet  # noqa: E402
import benchmarks.gate as gate  # noqa: E402
import benchmarks.roofline as jroofline  # noqa: E402
import benchmarks.runtime_throughput as jruntime  # noqa: E402
import benchmarks.telemetry_queries as jtelemetry  # noqa: E402
from repro_torch.launch import bench  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import fleet_throughput, roofline, runtime_throughput  # noqa: E402
from repro_torch.launch import run as run_all  # noqa: E402
from repro_torch.launch import telemetry_queries, train_throughput  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# wall-clock fields of each payload; everything else is virtual time or counts
WALL = {
    "telemetry_queries": {"per_query_us_small", "per_query_us_large", "cost_ratio",
                          "per_query_us_live_run"},
    "runtime_throughput": {"wall_rps", "sim_speedup_x", "decision_to_effect_ms"},
    "fleet_throughput": {"wall_s", "events_per_s"},
}
# train_throughput's documented renames (port key -> reference key)
TRAIN_RENAMES = {"first_pass_s": "compile_s", "torch": "jax"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The networks are tiny: one intra-op thread, so that parallel test
    workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def out_dirs(tmp_path, monkeypatch):
    """Both packages' results dirs under ``tmp_path``: (reference, port)."""
    ref, ours = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(jcommon, "_OUT_DIR", None)
    monkeypatch.setattr(bench, "_OUT_DIR", None)
    jcommon.set_results_dir(str(ref))
    bench.set_results_dir(str(ours))
    return ref, ours


def load(path: Path, name: str) -> dict:
    return json.loads((path / f"{name}.json").read_text())


def drop(d, keys):
    return {k: drop(v, keys) for k, v in d.items()
            if k not in keys} if isinstance(d, dict) else d


def key_tree(d):
    return {k: key_tree(v) for k, v in d.items()} if isinstance(d, dict) else None


@pytest.mark.parametrize("name, ours, ref, quick", [
    ("telemetry_queries", telemetry_queries.run, jtelemetry.run, True),
    ("runtime_throughput", runtime_throughput.run, jruntime.run, True),
    ("runtime_throughput", runtime_throughput.run, jruntime.run, False),
    ("fleet_throughput", fleet_throughput.run, jfleet.run, True),
], ids=["telemetry", "runtime", "runtime-full", "fleet"])
def test_virtual_time_fields_equal_the_reference(name, ours, ref, quick, out_dirs):
    rows_ref = ref(quick=quick)
    rows = ours(quick=quick, device="cpu")
    got, want = load(out_dirs[1], name), load(out_dirs[0], name)
    assert got.pop("device")["type"] == "cpu"
    assert drop(got, WALL[name]) == drop(want, WALL[name])
    assert [r[1] for r in rows] == [r[1] for r in rows_ref]


def test_committed_h100_runtime_payload_repeats_on_the_cpu(out_dirs):
    """The card's full-size run (``experiments/results/h100/``) is host NumPy
    in virtual time: a CPU run gives the same fields."""
    committed = json.loads((ROOT / "experiments/results/h100/runtime_throughput.json")
                           .read_text())
    assert committed.pop("device")["type"] == "cuda"
    runtime_throughput.run(device="cpu")
    got = load(out_dirs[1], "runtime_throughput")
    got.pop("device")
    wall = WALL["runtime_throughput"]
    assert drop(got, wall) == drop(committed, wall)


def test_train_throughput_payload_keys_equal_the_committed_baseline(out_dirs):
    rows = train_throughput.run(quick=True, device="cpu")
    got = load(out_dirs[1], "train_throughput")
    assert got["device"]["type"] == "cpu" and got["mode"] == "quick"
    want = json.loads((ROOT / "experiments/results/train_throughput.json").read_text())

    def renamed(tree):
        return {TRAIN_RENAMES.get(k, k): renamed(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree
    got_keys = renamed(key_tree(got))
    got_keys["device"] = None           # the device block replaces the platform string
    assert got_keys == key_tree(want)
    steps = got["steps_per_episode"]
    assert steps == 30 and got["legacy"]["episodes"] == 2
    for n, v in got["vectorized"].items():
        assert v["episodes"] == int(n)
        assert v["steps_per_s"] == pytest.approx(v["episodes_per_s"] * steps)
    assert [r[1] for r in rows] == ["legacy.steps_per_s", "vec1.steps_per_s", "vec8.steps_per_s",
                                    "vec32.steps_per_s", "speedup_episodes_at_32"]
    # benchmarks/gate.py gates the port's JSON as it is
    path = str(out_dirs[1] / "train_throughput.json")
    assert gate.main([path, "--baseline", path, "--metric", "vectorized.32.steps_per_s",
                      "--min-ratio", "0.5"]) == 0


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    """Dry-run records of smoke configs, written by ``launch/dryrun``:
    two OK (one given a measured block), a DOES_NOT_FIT, a SKIP."""
    out = tmp_path_factory.mktemp("dryrun")
    recs = [dryrun.count(a, s, smoke=True) for a, s in (
        ("llama3.2-1b", "prefill_32k"), ("llama3.2-1b", "decode_32k"),
        ("llama3.2-1b", "train_4k"), ("whisper-small", "long_500k"))]
    assert [r["status"] for r in recs] == ["OK", "OK", "DOES_NOT_FIT", "SKIP"]
    recs[1]["measured"] = {"device": "test", "ms": 0.5, "first_step_ms": 3.0, "reps": 5,
                           "peak_bytes": 1, "peak_over_counted": 1.0,
                           "share_of_bound": recs[1]["roofline"]["bound_s"] * 1e3 / 0.5}
    dryrun.write(recs, str(out))
    return out


def test_roofline_reads_the_card_records(dryrun_dir, out_dirs, monkeypatch):
    tab = roofline.table(dryrun_dir=str(dryrun_dir))
    assert [(x["arch"], x["shape"], x["status"]) for x in tab] == [
        ("llama3.2-1b", "prefill_32k", "OK"), ("llama3.2-1b", "decode_32k", "OK"),
        ("llama3.2-1b", "train_4k", "DOES_NOT_FIT"), ("whisper-small", "long_500k", "SKIP")]
    oks = tab[:2]
    assert oks[0]["step_time_bound_s"] >= oks[1]["step_time_bound_s"]
    for x in oks:
        assert x["collective_s"] is None and x["mesh"] == "1x1"
        assert x["step_time_bound_s"] == max(x["compute_s"], x["memory_s"])
    assert oks[0]["measured_ms"] is None and oks[1]["measured_ms"] == 0.5
    assert "> 80 GB" in tab[2]["reason"] and tab[3]["reason"].startswith("enc-dec")

    rows = roofline.run(device="cpu", dryrun_dir=str(dryrun_dir))
    assert rows[0] == ("roofline", "records_ok", 2, "of 4 records")
    assert rows[-1][1] == "llama3.2-1b|decode_32k.share_of_bound"
    assert load(out_dirs[1], "roofline_1x1")["rows"] == json.loads(json.dumps(tab))

    md = roofline.markdown(dryrun_dir=str(dryrun_dir), baseline_dir=str(dryrun_dir))
    lines = md.splitlines()
    assert len(lines) == 2 + len(tab) and "| 0.5000 |" in lines[3]
    assert "DOES_NOT_FIT: peak" in lines[4] and "SKIP: enc-dec" in lines[5]

    # the reference's collector cannot read these records: the peak is no
    # ``memory.peak_bytes`` there (and ``collective_s`` is None)
    monkeypatch.setattr(jroofline, "DRYRUN_DIR", str(dryrun_dir))
    with pytest.raises(KeyError, match="memory"):
        jroofline.table("1x1")


def test_run_only_runs_one_suite_and_refuses_unknown(out_dirs, capsys):
    run_all.main(["--only", "telemetry", "--quick", "--device", "cpu",
                  "--out", str(out_dirs[1])])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "benchmark,metric,value,reference"
    assert "telemetry,cost_ratio" in out
    assert sorted(p.name for p in out_dirs[1].iterdir()) == ["telemetry_queries.json"]
    with pytest.raises(SystemExit, match="unknown suite"):
        run_all.main(["--only", "telemetry,nope", "--device", "cpu"])
    assert set(run_all.SUITES) == {"fig3", "fig45", "fig6", "fig7", "roofline", "runtime",
                                   "train", "runtime_train", "telemetry", "fleet",
                                   "calibration"}


@pytest.mark.parametrize("call", [
    lambda: telemetry_queries.run(quick=True),
    lambda: runtime_throughput.run(quick=True),
    lambda: fleet_throughput.run(quick=True),
    lambda: train_throughput.run(quick=True),
    lambda: roofline.run(quick=True),
    lambda: run_all.runtime_train(quick=True),
    lambda: run_all.calibration(quick=True),
], ids=["telemetry", "runtime", "fleet", "train", "roofline", "runtime_train",
        "calibration"])
def test_launchers_default_to_cuda(call, out_dirs, monkeypatch):
    """Asking for CUDA without a GPU raises through resolve_device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()
    assert not out_dirs[1].exists()
