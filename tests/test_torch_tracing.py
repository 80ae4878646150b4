"""The serving path's spans and counters (``repro_torch.tracing``) on the CPU.

Nothing is stored unless recording; spans are stored under ``recording()``
and while a ``torch.profiler`` session records, and stop with it; they nest
from the control loop down to the stage's forward and carry the request ids
served, so that a request's path and an execute's parts can be read back;
they share the profiler's clock; the forward's kinds add up to at most its
time, and under the profiler alone only the forward's and the MoE layers'
bounds are marked; the MoE's slot counts equal a count by hand; and recording
changes no output bit.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, tracing  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.serving.engine import StageServer  # noqa: E402

moe_mod = importlib.import_module("repro_torch.nn.moe")  # ``repro_torch.nn.moe`` is the function

ARCH_KINDS = {
    "llama3.2-1b": {"attention", "mlp", "head"},
    "whisper-small": {"attention", "cross", "mlp", "head"},
    "granite-moe-3b-a800m": {"attention", "moe", "head"},
    "xlstm-125m": set(),
}


@pytest.fixture(scope="module")
def server():
    return StageServer("s", [ARCHS[n].smoke() for n in ARCH_KINDS], seq_len=16,
                       seed=3, device="cpu")


def tokens(B=3, S=16, seed=0):
    return np.random.default_rng(seed).integers(1, 512, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def session():
    exp = api.ExperimentSpec(
        pipeline=api.get_pipeline("serve3"),
        scenario=api.replace(api.get_scenario("steady_high"), rate=6.0, horizon=20, seed=5),
        controller=api.get_controller("greedy"), backend="runtime", real=True, seq_len=16)
    return api.Session(exp, device="cpu", smoke=True)


def test_recorder_keeps_spans_to_its_cap_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 2)
    rec = tracing.Recorder()
    for i in range(3):
        s = tracing.Span(f"s{i}", {}, False)
        s.start_ns, s.end_ns = 10 * i, 10 * i + 5
        rec.add(s)
    assert [s.name for s in rec.spans] == ["s0", "s1"] and rec.dropped == 1
    assert [s.name for s in rec.between(6, 12)] == ["s1"]
    assert [s.name for s in rec.between(5, 10)] == ["s0", "s1"]


def test_nothing_is_recorded_by_default(server, session):
    before = len(tracing.RECORDER.spans)
    assert not tracing.recording_now()
    server.execute(2, tokens())
    rep = session.serve()
    assert len(tracing.RECORDER.spans) == before and tracing._execute is None
    # the report's walls still come from the spans' stamps
    assert len(rep["decide_wall_s"]) == len(rep["rewards"]) > 0
    assert all(0 <= w < 60 for w in rep["decide_wall_s"])


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_recorded_while_recording_and_not_after(server, how):
    before = len(tracing.RECORDER.spans)
    if how == "recording":
        with tracing.recording() as rec:
            assert tracing.recording_now()
            server.execute(0, tokens())
        got = rec.spans
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            assert tracing.recording_now()
            server.execute(0, tokens())
        got = tracing.RECORDER.spans[before:]
    assert [s.name for s in got] == ["execute.inputs", "execute.forward", "execute.output",
                                     "execute"]
    assert not tracing.recording_now() and tracing._execute is None
    n = len(tracing.RECORDER.spans)
    server.execute(0, tokens())
    assert len(tracing.RECORDER.spans) == n and len(got) == 4


@pytest.fixture(scope="module")
def served(session):
    envs = []
    with tracing.recording() as rec:
        rep = session.serve(on_step=lambda env, cfg, info: envs.append(env))
    return rec, rep, envs[-1]


def test_spans_nest_and_carry_the_served_request_ids(served):
    rec, rep, env = served
    by_id = {s.id: s for s in rec.spans}
    names = [s.name for s in rec.spans]
    n_steps = len(rep["rewards"])
    assert names.count("serve.step") == names.count("serve.decide") == n_steps
    assert names.count("runtime.apply") == n_steps

    def parent(s):
        return by_id[s.parent]

    def inside(s, p):
        return p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns

    batches = [s for s in rec.spans if s.name == "runtime.batch"]
    assert batches and names.count("execute") == len(batches)
    for s in rec.spans:
        want = {"execute.inputs": "execute", "execute.forward": "execute",
                "execute.output": "execute", "execute": "runtime.batch",
                "runtime.apply": "serve.step"}.get(s.name)
        if want:
            assert parent(s).name == want and inside(s, parent(s)), s.name
    # a batch runs inside an interval's step, or in the drain after the last one
    for b in batches:
        assert b.parent is None or (parent(b).name == "serve.step" and inside(b, parent(b)))
    assert any(b.parent is not None for b in batches)
    for b in batches:
        assert len(b.attrs["rids"]) == b.attrs["rows"]
        ex = next(s for s in rec.spans if s.name == "execute" and s.parent == b.id)
        assert ex.attrs["B"] == b.attrs["rows"] and ex.attrs["S"] == 16
    served = sorted(r.rid for r in env.runtime.completed)
    assert len(served) == rep["summary"]["served"] > 0
    for stage in range(3):
        rids = sorted(r for b in batches if b.attrs["stage"] == stage for r in b.attrs["rids"])
        assert rids == served, stage
    # the report's walls are the spans' own
    decides = [s for s in rec.spans if s.name == "serve.decide"]
    assert rep["decide_wall_s"] == [s.seconds for s in decides]
    assert [s.attrs["step"] for s in decides] == list(range(n_steps))


def test_a_requests_path_and_its_executes_parts_are_read_from_the_spans(served):
    rec, _, env = served
    kids = {}
    for s in rec.spans:
        kids.setdefault(s.parent, []).append(s)
    for req in env.runtime.completed[:5]:
        path = [s for s in rec.spans if s.name == "runtime.batch" and req.rid in s.attrs["rids"]]
        assert [b.attrs["stage"] for b in path] == [0, 1, 2]
        assert all(a.end_ns <= b.start_ns for a, b in zip(path, path[1:]))
        for b in path:
            (ex,) = kids[b.id]
            parts = kids[ex.id]
            assert [p.name for p in parts] == ["execute.inputs", "execute.forward",
                                               "execute.output"]
            assert ex.start_ns <= parts[0].start_ns
            assert all(p.end_ns <= q.start_ns for p, q in zip(parts, parts[1:]))
            assert parts[-1].end_ns <= ex.end_ns


def test_a_profiler_event_inside_a_span_lies_within_its_stamps():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans = []
        for _ in range(5):
            with tracing.span("probe") as sp:
                with record_function("probe.event"):
                    torch.ones(64).add_(1)
            spans.append(sp)
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe.event")
    assert len(events) == len(spans) == 5
    for sp, (s, e) in zip(spans, events):
        assert sp.start_ns <= s <= e <= sp.end_ns


@pytest.mark.parametrize("z,arch", list(enumerate(ARCH_KINDS)))
def test_kind_times_add_up_to_at_most_the_forward(server, z, arch):
    with tracing.recording() as rec:
        server.execute(z, tokens(seed=z))
    ex = rec.spans[-1]
    kinds = {k[3:] for k in ex.attrs if k.startswith("ms.")} - {"forward"}
    assert ex.name == "execute" and ex.attrs["arch"] == arch
    assert kinds == ARCH_KINDS[arch]
    fwd = next(s for s in rec.spans if s.name == "execute.forward")
    total = ex.attrs["ms.forward"]
    assert 0 < total <= fwd.seconds * 1e3
    assert sum(ex.attrs[f"ms.{k}"] for k in kinds) <= total
    assert all(ex.attrs[f"ms.{k}"] > 0 for k in kinds)
    assert ("moe.slots" in ex.attrs) == (arch == "granite-moe-3b-a800m")


@pytest.mark.parametrize("z,arch", list(enumerate(ARCH_KINDS)))
def test_under_the_profiler_alone_only_the_forward_and_moe_bounds_are_marked(server, z, arch):
    from torch.profiler import ProfilerActivity, profile

    before = len(tracing.RECORDER.spans)
    with profile(activities=[ProfilerActivity.CPU]):
        server.execute(z, tokens(seed=z))
    ex = tracing.RECORDER._spans[-1]
    assert len(tracing.RECORDER._spans) == before + 4 and ex.name == "execute"
    n_moe = server.variants[z].n_layers if "moe" in ARCH_KINDS[arch] else 0
    assert [k for k, _ in ex.marks] == [None] + ["moe", None] * n_moe + [None]
    kinds = {k[3:] for k in tracing.RECORDER.spans[-1].attrs if k.startswith("ms.")}
    assert kinds == {"forward"} | ({"moe"} & ARCH_KINDS[arch])
    assert ex.attrs.get("ms.moe", 0.0) <= ex.attrs["ms.forward"]


def test_device_times_are_read_when_the_spans_are_read(server):
    with tracing.recording() as rec:
        server.execute(2, tokens())
    ex = rec._spans[-1]
    assert ex.name == "execute" and "ms.forward" not in ex.attrs and ex.marks and ex.moe
    assert rec.spans[-1] is ex and not ex.marks and not ex.moe
    assert {"ms.forward", "ms.moe", "moe.slots", "moe.slots_used"} <= set(ex.attrs)


def test_moe_slot_counts_equal_a_count_by_hand(server, monkeypatch):
    cfg = server.variants[2]
    assert cfg.n_experts == 4 and moe_mod._phys_experts(cfg.n_experts) == 4
    routes = []
    route = moe_mod._route

    def kept(*args, **kw):
        out = route(*args, **kw)
        routes.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(moe_mod, "_route", kept)
    B, S = 5, 16
    with tracing.recording() as rec:
        server.execute(2, tokens(B, S, seed=7))
    ex = rec.spans[-1]
    C = max(1, min(S, int(1.25 * S * cfg.top_k / cfg.n_experts)))
    assert len(routes) == cfg.n_layers
    assert ex.attrs["moe.slots"] == cfg.n_layers * B * 4 * C
    assert ex.attrs["moe.slots_used"] == sum(int((g > 0).sum()) for g in routes)
    assert 0 < ex.attrs["moe.slots_used"] <= min(ex.attrs["moe.slots"],
                                                 cfg.n_layers * B * S * cfg.top_k)


@pytest.mark.parametrize("z", range(len(ARCH_KINDS)))
def test_outputs_are_bit_identical_with_recording_on_and_off(server, z):
    toks = tokens(4, 16, seed=11 + z)
    off = server.execute(z, toks)
    with tracing.recording():
        on = server.execute(z, toks)
    assert np.array_equal(off, on) and on.dtype == off.dtype
