"""Spans and counters of the serving path, on the profiler's clock.

A span is a named interval of the host's work: its name, start and end
(``time.time_ns()``), its id, the id of the recorded span open around it
(its parent) and a small dict of attributes. ``torch.profiler`` converts
its events to the same Unix nanoseconds, so a span lines up with the
device intervals of a profile taken over the same time, with no
conversion. A span's ``seconds`` comes from a monotonic pair of stamps
(``time.perf_counter_ns()``) taken at the same two points.

Spans are stored only while recording: inside ``with recording():``, or
while a ``torch.profiler`` session records (the rule ``record_function``
follows). Outside both a span still takes its stamps, which the report's
wall times read, and stores nothing. No span makes a profiler annotation
(``record_function`` or NVTX): the profiler mirrors those onto the
device, where a reader of the trace would take them for kernel time.

The serving path's spans, each inside the one above it:

  ``serve.decide``    ``Session.serve``, the controller's decision       step
  ``serve.step``      ``Session.serve``, the env's interval               step
  ``runtime.apply``   ``RuntimeEnv.begin_step``, the reconfiguration
  ``runtime.batch``   ``ServingRuntime._on_complete``: the live executor
                      and the fan-out of its rows       stage, variant, rows, rids
  ``execute``         ``StageServer.execute``             stage, arch, B, S
  ``execute.inputs``  tokens and stub inputs to the device
  ``execute.forward`` ``models.api.forward``: the host's enqueue
  ``execute.output``  argmax, cast and the copy to the host (waits for the card)

An operator records one serve with ``with recording() as rec:
session.serve()``; ``rec.spans`` then holds its spans, and a request's
path is the ``runtime.batch`` spans whose ``rids`` hold its id, each the
parent of one ``execute``.

A recorded ``execute`` is the open one (``_execute``) for the sites inside
it: the ``inner`` spans, the forward's kind boundaries (``mark``) and the
MoE's slot counts (``count_moe``) leave their marks and counts on it, and
a reader of the recorder (``Recorder.spans``, ``between``) turns them into
its attributes, off the serving path (each CUDA call costs the host
several microseconds, and whisper-small's forward waits on the host):
``ms.forward`` (the forward's device time), ``ms.<kind>`` (the time
between a kind's bounds on the device's timeline, so a gap in which the
card waits for the host's launches counts too; CUDA events on the card,
complete once the execute's own copy to the host has waited for the card;
host stamps on the CPU, whose ops are synchronous) and ``moe.slots`` /
``moe.slots_used`` (capacity slots computed, and those holding a token,
summed over the MoE layers). Inside ``recording()`` every kind is marked:
``attention``, ``cross``, ``mlp``, ``moe`` and ``head``. While only a
profiler records, only the forward's two bounds and the MoE layers' bounds
are, so that the marks of a dense forward add nothing to the trace they
are read against.
"""
from __future__ import annotations

import contextlib
import itertools
import time

import torch

CAP = 1 << 20  # spans a recorder keeps; later ones are counted in ``dropped``


class Recorder:
    """Spans in memory, in the order they ended, up to ``CAP``."""

    def __init__(self):
        self.cap = CAP
        self._spans: list[Span] = []
        self._unread: list[Execute] = []   # executes whose device times are not read yet
        self.dropped = 0

    def add(self, span: Span):
        if len(self._spans) < self.cap:
            self._spans.append(span)
            if isinstance(span, Execute) and (span.marks or span.moe):
                self._unread.append(span)
        else:
            self.dropped += 1

    @property
    def spans(self) -> list[Span]:
        for s in self._unread:
            s.attrs.update(_read(s.marks, s.moe))
            s.marks, s.moe = [], []
        self._unread.clear()
        return self._spans

    def between(self, t0_ns: int, t1_ns: int) -> list[Span]:
        """The spans that overlap ``[t0_ns, t1_ns]``."""
        return [s for s in self.spans if s.start_ns <= t1_ns and s.end_ns >= t0_ns]


RECORDER = Recorder()  # where spans go outside ``recording()``: a profiled run's
_store = RECORDER
_forced = 0            # open ``recording()`` blocks
_open = None           # id of the innermost recorded span that is open
_ids = itertools.count(1)
_execute = None        # the open ``execute`` span, if it is recorded


def recording_now() -> bool:
    return _forced > 0 or torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def recording():
    """Record every span of the block into a fresh ``Recorder``, which the
    block receives: ``with recording() as rec: session.serve()``."""
    global _store, _forced
    prev, _store = _store, Recorder()
    _forced += 1
    try:
        yield _store
    finally:
        _forced -= 1
        _store = prev


class Span:
    """One span; ``seconds`` is its wall, recorded or not."""

    __slots__ = ("name", "attrs", "on", "id", "parent", "start_ns", "end_ns", "_t0", "_t1")

    def __init__(self, name: str, attrs: dict, on: bool):
        self.name, self.attrs, self.on = name, attrs, on
        self.id = self.parent = None

    def __enter__(self):
        global _open
        if self.on:
            self.id, self.parent = next(_ids), _open
            _open = self.id
        self.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _open
        self._t1 = time.perf_counter_ns()
        self.end_ns = time.time_ns()
        if self.on:
            _open = self.parent
            _store.add(self)
        return False

    @property
    def seconds(self) -> float:
        return (self._t1 - self._t0) / 1e9


class Execute(Span):
    """``StageServer.execute``'s span; while it is open and recorded, it
    keeps its forward's marks (kind or None, CUDA event or host ns), the MoE
    layers' counts (slots, device scalar of the slots used) and the stream
    its forward runs on (None on the CPU)."""

    __slots__ = ("kinds", "marks", "moe", "stream")

    def __init__(self, attrs: dict, on: bool):
        super().__init__("execute", attrs, on)
        self.kinds = _forced > 0          # every kind, or the forward's and MoE's bounds
        self.marks, self.moe, self.stream = [], [], None

    def __enter__(self):
        global _execute
        if self.on:
            _execute = self
        return super().__enter__()

    def __exit__(self, *exc):
        global _execute
        _execute = None
        if exc[0] is not None:
            self.marks, self.moe = [], []
        return super().__exit__(*exc)


def span(name: str, **attrs) -> Span:
    """A span recorded if recording now."""
    return Span(name, attrs, recording_now())


def execute(**attrs) -> Execute:
    """``StageServer.execute``'s span: it samples the recording state for the
    sites inside it and keeps their device times and counts."""
    return Execute(attrs, recording_now())


def inner(name: str, **attrs) -> Span:
    """A span inside ``execute``, recorded if it is."""
    return Span(name, attrs, _execute is not None)


def mark(kind: str | None, like: torch.Tensor):
    """From here on the forward runs ``kind`` (``None``: no kind), on
    ``like``'s device. Consecutive kinds share one boundary. On the card a
    boundary is a timing event recorded on the device's current stream,
    looked up once a forward. Outside ``recording()`` only the bounds of the
    forward and of a MoE layer are marked."""
    ex = _execute
    if ex is None:
        return
    if not ex.kinds and kind not in (None, "moe"):
        if not ex.marks or ex.marks[-1][0] != "moe":
            return
        kind = None                       # the end of a MoE layer
    if not ex.marks and like.device.type == "cuda":
        ex.stream = torch.cuda.current_stream(like.device)
    if ex.stream is None:
        ex.marks.append((kind, time.perf_counter_ns()))
        return
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(ex.stream)
    ex.marks.append((kind, ev))


def count_moe(slots: int, used: torch.Tensor):
    """One MoE layer's ``slots`` computed and ``used`` (a device scalar) of
    them holding a token, kept without a read."""
    if _execute is not None:
        _execute.moe.append((slots, used))


def _read(marks: list, moe: list) -> dict:
    """An execute's attributes from its marks and MoE counts."""
    def ms(a, b):
        return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) / 1e6

    out: dict[str, float] = {}
    for (kind, a), (_, b) in zip(marks, marks[1:]):
        if kind is not None:
            out[kind] = out.get(kind, 0.0) + ms(a, b)
    if len(marks) > 1:
        out["forward"] = ms(marks[0][1], marks[-1][1])
    attrs = {f"ms.{k}": v for k, v in out.items()}
    if moe:
        attrs["moe.slots"] = sum(n for n, _ in moe)
        attrs["moe.slots_used"] = int(sum(u.item() for _, u in moe))
    return attrs
