"""The port's reprolint (``repro_torch.analysis``: RPL004, RPL006, RPL007)
on caught/clean fixture pairs, against the reference's rules where they
share a code, plus suppression, the CLI, and the gate on the port's own
tree (``src/repro_torch`` and ``chip_smoke.py`` lint clean).

The reference's RPL004 and RPL006 fixtures (``tests/test_analysis.py``'s
``TestSpecSafety`` and ``TestTimedRegionSync``) go to both packages'
``analyze_source``, RPL006's with ``benchmarks/`` mapped to
``src/repro_torch/launch/``: the findings of the shared code (rule,
severity, line, column) are equal.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import analyze_source as janalyze_source
from repro_torch.analysis import RULES, analyze_source
from repro_torch.analysis.cli import main as reprolint_main

ROOT = Path(__file__).resolve().parents[1]
LAUNCH = "src/repro_torch/launch/fixture.py"
CORE = "src/repro_torch/core/fixture.py"


def codes(src, path=CORE):
    return {f.rule for f in analyze_source(src, path)}


def found(src, path, code):
    return [f for f in analyze_source(src, path) if f.rule == code]


def where(findings, code):
    return [(f.rule, f.severity, f.line, f.col) for f in findings if f.rule == code]


# the reference's fixtures (tests/test_analysis.py), as they are
SPEC_UNSAFE = (
    "from dataclasses import dataclass\n"
    "@dataclass\n"
    "class FooSpec:\n"
    "    x: object\n"
)
SPEC_CLEAN = (
    "from dataclasses import dataclass\n"
    "@dataclass(frozen=True)\n"
    "class FooSpec:\n"
    "    name: str\n"
    "    sizes: tuple[int, ...]\n"
    "    child: BarSpec | None\n"
    "    def to_dict(self):\n"
    "        return {}\n"
    "    @classmethod\n"
    "    def from_dict(cls, d):\n"
    "        return cls(**d)\n"
)
SPEC_NOT_A_SPEC = "class Helper:\n    x: object\n"
SYNC_IN_WINDOW = (
    "import time\n"
    "import numpy as np\n"
    "def run(step, x):\n"
    "    t0 = time.perf_counter()\n"
    "    out = step(x)\n"
    "    v = out.item()\n"
    "    host = np.asarray(out)\n"
    "    wall = time.perf_counter() - t0\n"
    "    return wall, v, host\n"
)
SYNC_IN_TIMED_FN = (
    "from benchmarks.common import time_fn\n"
    "def run(step, x):\n"
    "    def one_pass():\n"
    "        return step(x).item()\n"
    "    return time_fn(one_pass, reps=3).best\n"
)
SYNC_OUTSIDE = (
    "import time\n"
    "import numpy as np\n"
    "def run(step, x):\n"
    "    t0 = time.perf_counter()\n"
    "    out = step(x)\n"
    "    wall = time.perf_counter() - t0\n"
    "    return wall, float(np.asarray(out).mean())\n"
)


def test_rule_catalogue():
    assert set(RULES) == {"RPL004", "RPL006", "RPL007"}


@pytest.mark.parametrize("code, src", [
    ("RPL004", SPEC_UNSAFE), ("RPL004", SPEC_CLEAN), ("RPL004", SPEC_NOT_A_SPEC),
    ("RPL006", SYNC_IN_WINDOW), ("RPL006", SYNC_IN_TIMED_FN), ("RPL006", SYNC_OUTSIDE),
], ids=["spec-unsafe", "spec-clean", "not-a-spec", "sync-in-window", "sync-in-timed-fn",
        "sync-outside"])
def test_shared_codes_find_what_the_reference_finds(code, src):
    ref_path, path = "benchmarks/fixture.py", LAUNCH
    ours = where(analyze_source(src, path), code)
    want = where(janalyze_source(src, ref_path), code)
    assert ours == want
    if code == "RPL004":
        msgs = [f.message for f in analyze_source(src, path) if f.rule == code]
        assert msgs == [f.message for f in janalyze_source(src, ref_path) if f.rule == code]


def test_spec_safety_messages():
    msgs = [f.message for f in analyze_source(SPEC_UNSAFE, CORE)]
    for part in ("frozen=True", "to_dict", "from_dict", "not JSON-safe"):
        assert any(part in m for m in msgs)


def test_torch_syncs_caught_and_synchronize_allowed():
    src = (
        "import time\n"
        "import numpy as np\n"
        "import torch\n"
        "def run(step, x):\n"
        "    t0 = time.perf_counter()\n"
        "    out = step(x)\n"
        "    torch.cuda.synchronize()\n"
        "    a = out.cpu()\n"
        "    b = out.tolist()\n"
        "    c = out.numpy()\n"
        "    d = np.array(out)\n"
        "    wall = time.perf_counter() - t0\n"
        "    return wall, a, b, c, d, out.cpu()\n"
    )
    hits = found(src, LAUNCH, "RPL006")
    assert [f.line for f in hits] == [8, 9, 10, 11]
    assert all(f.severity == "error" for f in hits)
    assert "synchronise, stop the clock" in hits[0].message
    assert [f.line for f in found(src, "chip_smoke.py", "RPL006")] == [8, 9, 10, 11]
    # synchronise, stop the clock, then copy: clean
    clean = src.replace("    a = out.cpu()\n    b = out.tolist()\n    c = out.numpy()\n"
                        "    d = np.array(out)\n", "").replace(", a, b, c, d", "")
    assert not found(clean, LAUNCH, "RPL006")


def test_sync_in_function_handed_to_time_interleaved():
    src = (
        "from repro_torch.timing import time_interleaved\n"
        "def run(step, x):\n"
        "    def one():\n"
        "        step(x).cpu()\n"
        "    def two():\n"
        "        step(x)\n"
        "    return time_interleaved([one, two], device='cuda')\n"
    )
    assert [f.line for f in found(src, LAUNCH, "RPL006")] == [4]


def test_sync_rule_scope():
    assert "RPL006" in codes(SYNC_IN_WINDOW, LAUNCH)
    assert "RPL006" in codes(SYNC_IN_WINDOW, "chip_smoke.py")
    assert "RPL006" not in codes(SYNC_IN_WINDOW, CORE)
    assert "RPL006" not in codes(SYNC_IN_WINDOW, "benchmarks/fixture.py")


GLOBAL_DRAWS = (
    "import random\n"
    "import numpy as np\n"
    "import torch\n"
    "from torch import randint\n"
    "def f(x, g):\n"
    "    a = torch.randn(2, 3)\n"
    "    b = randint(0, 5, (4,))\n"
    "    x.normal_(0.0, 1.0)\n"
    "    torch.nn.init.uniform_(x)\n"
    "    torch.manual_seed(0)\n"
    "    torch.cuda.manual_seed_all(0)\n"
    "    c = np.random.rand(3)\n"
    "    rng = np.random.default_rng()\n"
    "    d = random.random()\n"
    "    e = torch.multinomial(x, 1)\n"
    "    return a, b, c, d, e, rng\n"
)
SEEDED_DRAWS = (
    "import random\n"
    "import numpy as np\n"
    "import torch\n"
    "def f(x, seed):\n"
    "    g = torch.Generator(device='cpu')\n"
    "    g.manual_seed(seed)\n"
    "    a = torch.randn(2, 3, generator=g)\n"
    "    x.normal_(0.0, 1.0, generator=g)\n"
    "    b = torch.randint(0, 5, (4,), generator=g)\n"
    "    rng = np.random.default_rng(seed)\n"
    "    ss = np.random.SeedSequence([seed, 1])\n"
    "    r = random.Random(seed)\n"
    "    return a, b, rng.normal(), ss, r.random(), torch.zeros(3)\n"
)


def test_global_generator_draws_caught():
    hits = found(GLOBAL_DRAWS, CORE, "RPL007")
    assert [f.line for f in hits] == list(range(6, 16))
    assert "generator=" in hits[0].message and "default_rng(seed)" in hits[6].message
    assert [f.line for f in found(GLOBAL_DRAWS, "chip_smoke.py", "RPL007")] == list(range(6, 16))


def test_seeded_draws_clean():
    assert not found(SEEDED_DRAWS, CORE, "RPL007")


def test_generator_rule_scope():
    assert "RPL007" not in codes(GLOBAL_DRAWS, "src/repro/core/fixture.py")
    assert "RPL007" not in codes(GLOBAL_DRAWS, "tests/test_fixture.py")


class TestSuppression:
    BAD = (
        "import torch\n"
        "a = torch.randn(2)\n"
        "b = torch.rand(2){}\n"
    )

    def test_line_ignore_silences(self):
        src = self.BAD.format("  # reprolint: ignore[RPL007] on purpose")
        assert [f.line for f in found(src, CORE, "RPL007")] == [2]

    def test_line_ignore_wrong_code_still_fires(self):
        src = self.BAD.format("  # reprolint: ignore[RPL999]")
        assert [f.line for f in found(src, CORE, "RPL007")] == [2, 3]

    def test_file_ignore_silences(self):
        src = "# reprolint: ignore-file[RPL007]\n" + self.BAD.format("")
        assert "RPL007" not in codes(src)

    def test_marker_inside_string_does_not_suppress(self):
        src = self.BAD.format(' + str("# reprolint: ignore[RPL007]")')
        assert [f.line for f in found(src, CORE, "RPL007")] == [2, 3]


class TestCli:
    @pytest.fixture
    def bad(self, tmp_path):
        f = tmp_path / "repro_torch" / "bad.py"
        f.parent.mkdir()
        f.write_text("import torch\nx = torch.randn(3)\n")
        return f

    def test_port_tree_is_clean(self, capsys):
        assert reprolint_main([str(ROOT / "src" / "repro_torch"),
                               str(ROOT / "chip_smoke.py")]) == 0
        assert "0 error(s)" in capsys.readouterr().out

    def test_error_finding_exits_nonzero(self, bad, capsys):
        assert reprolint_main([str(bad)]) == 1
        assert "RPL007" in capsys.readouterr().out

    def test_json_output(self, bad, capsys):
        reprolint_main([str(bad), "--json"])
        findings = json.loads(capsys.readouterr().out)
        assert findings[0]["rule"] == "RPL007"
        assert findings[0]["severity"] == "error"
        assert findings[0]["line"] == 2

    def test_select_strict_and_list_rules(self, bad, capsys):
        assert reprolint_main([str(bad), "--select", "RPL004"]) == 0
        assert reprolint_main([str(bad), "--select", "RPL004", "--strict"]) == 0
        assert reprolint_main([str(bad), "--select", "RPL001"]) == 2
        assert reprolint_main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for code in RULES:
            assert code in out

    def test_unparseable_file_reported(self, tmp_path, capsys):
        broken = tmp_path / "broken.py"
        broken.write_text("def f(:\n")
        assert reprolint_main([str(broken)]) == 1
        assert "RPL000" in capsys.readouterr().out

    def test_module_entry_point_needs_no_torch(self):
        """``python -m repro_torch.analysis`` runs stdlib-only: the lint
        loads neither torch nor jax."""
        code = ("import sys, runpy; sys.argv = ['x', '--list-rules']\n"
                "try:\n    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
                "except SystemExit as e:\n    assert e.code == 0\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'repro')]\n"
                "print(bad); sys.exit(bool(bad))")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=120,
                             env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
        assert res.returncode == 0, res.stdout + res.stderr
        assert "RPL007" in res.stdout
