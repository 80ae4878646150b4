"""The control of ``correct`` at a size a test run holds: the reference
computed one precision below the configuration's bf16 (fp8 e4m3 matrices and
product inputs), put in the program's place, reads a widest gap over the
cell's limit for at least one architecture, so that the harness's own
decision on the checks with the control's tokens in the program's place comes
out not correct, while the bf16 program's dense and audio stages stay under
theirs. On the chip the same comparison runs at the cells' own sizes
(``calibrate.py``); PERF.md gives its readings."""

import pytest

from portbench import harness, smoke, spec


# the smoke cells serve a tenth of the mix's rate, but where the variant a cell
# is for is chosen only at its full rate (edge4.steady240: llava-next)
VARIANT_AT_FULL_RATE = {"edge4.steady240": "llava-next-mistral-7b"}


@pytest.mark.parametrize("workload", ["edge4.steady120", "serve3.steady240", "edge4.steady240"])
def test_control_fails_the_cells_limits(tmp_path, workload):
    bench = spec.load_benchmark()
    cell_entry = spec.find_cell(bench, workload)
    limits = spec.load_config(bench, cell_entry["config"])["limits"]
    rate = (float(spec.load_traffic(cell_entry["traffic"])["rate"]) if workload in VARIANT_AT_FULL_RATE
            else None)
    root = smoke.make_root(tmp_path, workload, dtype="bfloat16", rate=rate)
    cell = harness.Cell(workload, root=root, device="cpu", log=lambda msg: None)
    cell.config["limits"] = limits
    window = cell.run(2**31 + 17, 0.0)  # one segment: the sample is fixed by the seed
    checks, _, details = cell.judge(window, control=True)
    archs = [a for a in details if a != "control_checks"]
    control = {a: details[a]["control"]["widest"] for a in archs}
    program = {a: details[a]["program"]["widest"] for a in archs}
    assert any(control[a] > limits[a] for a in control), (control, limits)
    assert not harness.passes(details["control_checks"]), details["control_checks"]
    for a in ("whisper-small", "starcoder2-3b"):
        assert program[a] < limits[a], (a, program[a])
    if workload in VARIANT_AT_FULL_RATE:
        a = VARIANT_AT_FULL_RATE[workload]
        assert program[a] < limits[a] < control[a], (a, program[a], control[a])
