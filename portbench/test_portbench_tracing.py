"""The readers of the program's own spans (``portbench/spans.py`` and the
metrics ``idle_forward_share``, ``idle_io_share``, ``idle_loop_share``,
``moe_share``, ``moe_slot_use``): on a synthetic slice the three idle
shares are the idle time split by overlap and add up to
``device_idle_share``; spans that stick out of the harness's annotations,
or no trace, give none; and a traced CPU run at smoke size reports the
MoE's share and slot use."""

import json
import time

import pytest

from portbench import spec, spans

from repro_torch import tracing

MS = 1_000_000
IDLE = ("idle_forward_share", "idle_io_share", "idle_loop_share")


def span(name, start_ms, end_ms, **attrs):
    s = tracing.Span(name, attrs, False)
    s.start_ns, s.end_ns = int(start_ms * MS), int(end_ms * MS)
    return s


@pytest.fixture
def recorded(monkeypatch):
    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "RECORDER", rec)
    return rec


def slice_ctx(device, annotations, t0=0, t1=100):
    return {"trace": {"device": [(s * MS, e * MS, "k") for s, e in device],
                      "annotations": [(s * MS, e * MS, "execute a") for s, e in annotations],
                      "t0_ns": t0 * MS, "t1_ns": t1 * MS, "batches": []}}


def two_batches(rec, shift_ms=0.0):
    """Two executes in a 100-ms slice: [10, 40] (forward [15, 30]) and
    [60, 90] (forward [62, 80]); the harness's annotations are [9.9, 40.1]
    and [59.95, 90.05]."""
    for a, f0, f1, b in ((10, 15, 30, 40), (60, 62, 80, 90)):
        rec.add(span("execute.inputs", a, f0))
        rec.add(span("execute.forward", f0, f1))
        rec.add(span("execute.output", f1, b))
        rec.add(span("execute", a + shift_ms, b, **{"ms.forward": 12.0, "ms.moe": 5.0,
                                                     "moe.slots": 400, "moe.slots_used": 250}))
    rec.add(span("runtime.batch", 5, 95))
    return slice_ctx(device=[(0, 12), (11, 14), (20, 28), (35, 50), (66, 70), (70, 85)],
                     annotations=[(9.9, 40.1), (59.95, 90.05)])


def test_idle_shares_split_the_idle_time_by_overlap(recorded):
    ctx = two_batches(recorded)
    got = {m: spec.load_reader(m)(ctx) for m in (*IDLE, "device_idle_share")}
    # idle: [14, 20], [28, 35], [50, 66], [85, 100] = 44 ms of 100
    # in forwards: [15, 20] + [28, 30] + [62, 66] = 11; in executes: + [14, 15] +
    # [30, 35] + [60, 62] + [85, 90] = 24, so io 13 and loop 20
    assert got["idle_forward_share"] == pytest.approx(11.0)
    assert got["idle_io_share"] == pytest.approx(13.0)
    assert got["idle_loop_share"] == pytest.approx(20.0)
    assert sum(got[m] for m in IDLE) == pytest.approx(got["device_idle_share"])


def test_moe_readers_sum_the_slice_s_executes(recorded):
    ctx = two_batches(recorded)
    assert spec.load_reader("moe_share")(ctx) == pytest.approx(10.0)
    assert spec.load_reader("moe_slot_use")(ctx) == pytest.approx(62.5)


@pytest.mark.parametrize("shift_ms", [-0.35, 0.25])
def test_spans_outside_the_annotations_give_none(recorded, shift_ms):
    ctx = two_batches(recorded, shift_ms)
    assert spans.aligned(spans.executes(ctx), ctx["trace"]["annotations"]) is (shift_ms > 0)
    for m in IDLE:
        assert (spec.load_reader(m)(ctx) is None) is (shift_ms < 0)


def test_no_trace_or_no_spans_give_none(recorded):
    for m in (*IDLE, "moe_share", "moe_slot_use"):
        assert spec.load_reader(m)({"trace": None}) is None
        assert spec.load_reader(m)(slice_ctx([(0, 50)], [(10, 20)])) is None


class StepClock:
    """The harness's clock for one test: each reading is ``step`` seconds
    after the last, so the window and its profiled slice hold the same
    batches however loaded the machine is. Everything else is ``time``'s."""

    def __init__(self, step: float):
        self.step, self.now = step, 0.0

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_traced_smoke_run_reports_the_moe_s_share_and_slot_use(tmp_path, monkeypatch):
    from portbench import harness, smoke

    # 1-s segments at 3 req/s; at 50 ms a reading of the harness's clock the
    # 1.8-s slice of a 6-s window holds whole segments, each ending in a
    # granite-moe batch, whatever the machine's load
    monkeypatch.setattr(harness, "time", StepClock(0.05))
    root = smoke.make_root(tmp_path, "serve3.steady240", limit=0.05, rate=3.0)
    mix = root / "portbench" / "traffic" / "steady_high.240.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "segment_s": 1}))
    cell = harness.Cell("serve3.steady240", root=root, device="cpu", log=lambda msg: None)
    window = cell.run(2**31 + 91, 6.0, True)
    stages = {b.stage for b in window["rec"].batches if b.traced}
    checks, acc, _ = cell.judge(window)
    out = harness.report(cell, window, True, checks, acc)
    assert out["correct"], out["checks"]
    assert 2 in stages, stages
    m = out["metrics"]
    assert 0 < m["moe_slot_use"]["value"] <= 100
    assert 0 < m["moe_share"]["value"] < 100
    # no device intervals on the CPU: no idle split, as no device_idle_share
    assert not set(IDLE) & set(m) and "device_idle_share" not in m
