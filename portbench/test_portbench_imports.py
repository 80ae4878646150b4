"""What the benchmark loads: no module whose top-level name (the part before
the first dot, compared whole, since ``repro_torch`` begins with ``repro``)
is ``jax``, ``jaxlib``, ``flax``, the JAX package ``repro`` or the JAX
package's ``benchmarks``; and the reference, with every reference module
under ``portbench/archs/``, loads nothing of the program.
Each check runs in a fresh interpreter, as a run does."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}

PROBE = """
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set[str]:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    mods = loaded("import portbench.reference, portbench.weights, portbench.counts\n"
                  "from portbench import spec\n"
                  "paths = sorted((spec.HERE / 'archs').glob('*.py'))\n"
                  "assert paths\n"
                  "for path in paths:\n"
                  "    assert spec.load_arch(path.stem) is not None")
    assert not mods & FORBIDDEN
    assert "repro_torch" not in mods


def test_a_whole_run_loads_no_jax():
    body = """
from portbench import harness, smoke
root = smoke.make_root(Path(tempfile.mkdtemp()), "edge4.steady120", limit=0.05)
cell = harness.Cell("edge4.steady120", root=root, device="cpu", log=lambda m: None)
window = cell.run(3, 0.5, True)
checks, acc, _ = cell.judge(window)
harness.report(cell, window, True, checks, acc)
import portbench.run
assert not window["forbidden"], window["forbidden"]
"""
    mods = loaded(body)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "edge4.steady120", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
