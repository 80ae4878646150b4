"""The program's own spans (``repro_torch.tracing``) over the traced slice.

While ``torch.profiler`` records, the program stores its spans, stamped on
the profiler's clock (Unix nanoseconds). The readers here take those that
overlap the slice ``[t0_ns, t1_ns]``. A program without the module, or a
run without a trace, gives ``None``: the metric is left out of the line.

The device's idle time in the slice (the complement of the union of the
device intervals, as ``trace.busy_ns`` counts it) is split by overlap,
interval by interval, into the parts inside an ``execute.forward`` span
(the host enqueueing the forward), inside an ``execute`` span but outside
its forward (inputs to the device, output to the host), and outside every
``execute`` span (the control loop and runtime); the three add up to
``device_idle_share``. Before it splits, a reader checks that every
``execute`` span lies inside one of the harness's ``execute <arch>``
annotations within ``ALIGN_NS`` at both ends, which holds only while the
two clocks agree.
"""

from __future__ import annotations

from portbench import trace

ALIGN_NS = 200_000


def program_spans(ctx):
    """The program's spans overlapping the slice, or None."""
    tr = ctx["trace"]
    if tr is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.RECORDER.between(tr["t0_ns"], tr["t1_ns"])


def aligned(execs, annotations) -> bool:
    """Every span of ``execs`` within ``ALIGN_NS`` of one annotation at both ends."""
    return all(any(a0 - ALIGN_NS <= s.start_ns and s.end_ns <= a1 + ALIGN_NS
                   for a0, a1, _ in annotations)
               for s in execs)


def _merged(spans, t0: int, t1: int):
    return trace.union(sorted((s.start_ns, s.end_ns) for s in spans), t0, t1)


def _overlap_ns(a, b) -> int:
    """Nanoseconds two sorted, merged interval lists share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(ctx):
    """{"forward", "io", "loop"}: the slice's device idle time in each part,
    in percent of the slice; None without a trace, device intervals or the
    program's spans, or when the spans and annotations disagree."""
    spans = program_spans(ctx)
    tr = ctx["trace"]
    if spans is None or not tr["device"]:
        return None
    execs = [s for s in spans if s.name == "execute"]
    if not execs or not aligned(execs, tr["annotations"]):
        return None
    t0, t1 = tr["t0_ns"], tr["t1_ns"]
    idle, prev = [], t0
    for s, e in trace.union(tr["device"], t0, t1):
        if s > prev:
            idle.append([prev, s])
        prev = e
    if prev < t1:
        idle.append([prev, t1])
    total = sum(e - s for s, e in idle)
    fwd = _overlap_ns(idle, _merged([s for s in spans if s.name == "execute.forward"], t0, t1))
    inside = _overlap_ns(idle, _merged(execs, t0, t1))
    scale = 100.0 / (t1 - t0)
    return {"forward": fwd * scale, "io": (inside - fwd) * scale, "loop": (total - inside) * scale}


def executes(ctx):
    """The slice's ``execute`` spans, or None."""
    spans = program_spans(ctx)
    if spans is None:
        return None
    return [s for s in spans if s.name == "execute"]
