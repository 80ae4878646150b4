"""The examples' twins (``examples/*_torch.py``) run on the CPU with
``runpy`` at small sizes, beside the reference's examples where their
lines can agree.

- compare_baselines: with every scenario's horizon cut to 30 s in both
  packages (a patch of ``get_scenario``; the twins are not changed for it),
  the header and the Random, Greedy and IPA lines equal the reference
  example's in cost, QoS and latency (host NumPy in both; the decision-H
  column is wall time and OPD trains on other draws);
- quickstart: with the horizon cut to 30 s, the pipeline line and the
  greedy line equal the reference's; OPD trains one episode;
- serve_pipeline: serve3 in virtual time for 30 s, one training episode,
  every request served (``--real`` serves at full width: card only);
- train_lm: two steps of a narrow xlstm-125m, a finite and falling loss;
- each twin asks for CUDA by default and raises without a card.
"""
import io
import math
import re
import runpy
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro_torch import api  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HORIZON = 30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The networks are tiny: one intra-op thread, so that parallel test
    workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short(monkeypatch):
    """Every registered scenario cut to HORIZON seconds, in both packages."""
    for mod in (api, japi):
        get = mod.get_scenario
        monkeypatch.setattr(mod, "get_scenario",
                            lambda name, get=get, mod=mod: mod.replace(get(name),
                                                                       horizon=HORIZON))


def example(name: str, *argv: str, monkeypatch) -> list[str]:
    """Run ``examples/<name>.py`` as ``__main__`` with ``argv``; its lines."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    return out.getvalue().splitlines()


def test_compare_baselines_equals_the_reference(short, monkeypatch):
    ours = example("compare_baselines_torch", "--episodes", "1", "--device", "cpu",
                   monkeypatch=monkeypatch)
    ref = example("compare_baselines", "--episodes", "1", monkeypatch=monkeypatch)
    assert ours[:3] == ref[:3] and ours[1].startswith(f"fluctuating: {HORIZON} s cycle")
    rows = {line.split()[0]: line.split() for line in ours[3:]}
    want = {line.split()[0]: line.split() for line in ref[3:]}
    assert list(rows) == list(want) == ["random", "greedy", "ipa", "opd"]
    for name in ("random", "greedy", "ipa"):
        assert rows[name][:4] == want[name][:4], name
    assert all(math.isfinite(float(x)) for x in rows["opd"][1:])


def test_quickstart_equals_the_reference_on_greedy(short, monkeypatch):
    ours = example("quickstart_torch", "--episodes", "1", "--device", "cpu",
                   monkeypatch=monkeypatch)
    ref = example("quickstart", "--episodes", "1", monkeypatch=monkeypatch)
    assert ours[0] == ref[0] == "pipeline: paper-4stage, 4 stages, 24 model variants total"
    greedy = [line for line in ours if line.startswith("greedy:")]
    assert greedy == [line for line in ref if line.startswith("greedy:")]
    assert [line for line in ours if line.startswith("episode ")] == [ours[2]]
    assert ours[-1].startswith("opd   : mean cost=")


def test_serve_pipeline_serves_every_request(monkeypatch):
    lines = example("serve_pipeline_torch", "--horizon", str(HORIZON), "--train-episodes",
                    "1", "--device", "cpu", monkeypatch=monkeypatch)
    assert lines[0].startswith("trained OPD agent for 1 episodes")
    assert sum(line.startswith("[t=") for line in lines) == HORIZON // 10
    served = re.search(r"served (\d+)/(\d+) requests", "\n".join(lines))
    assert served and served[1] == served[2] and int(served[1]) > 0
    assert lines[-1].startswith("stage utilization: ")


def test_train_lm_loss_falls(monkeypatch):
    lines = example("train_lm_torch", "--steps", "2", "--seq-len", "32", "--batch", "2",
                    "--d-model", "64", "--device", "cpu", monkeypatch=monkeypatch)
    assert lines[0].startswith("xlstm-125m: ")
    first, final = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)", lines[-1]).groups())
    assert math.isfinite(final) and final < first


@pytest.mark.parametrize("name, argv", [
    ("quickstart_torch", ["--episodes", "1"]),
    ("compare_baselines_torch", ["--episodes", "1"]),
    ("serve_pipeline_torch", ["--train-episodes", "1"]),
    ("train_lm_torch", ["--steps", "1"]),
], ids=["quickstart", "compare_baselines", "serve_pipeline", "train_lm"])
def test_twins_default_to_cuda(name, argv, short, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        example(name, *argv, monkeypatch=monkeypatch)
