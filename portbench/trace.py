"""Reduce a ``torch.profiler`` slice to device intervals and host annotations.

The device is busy while any kernel, copy or set runs: the union of their
intervals, so overlapping kernels are not counted twice. Idle gaps are named
by the harness's annotation that covers them (``execute <arch>``, inside a
stage forward) or ``runtime (outside execute)``.
"""

from __future__ import annotations

from collections import defaultdict


def events(prof):
    """(device intervals [(start_ns, end_ns, name)], annotations [(start, end, name)])."""
    dev, ann = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name().startswith("execute "):
            # the harness's annotation, on the host and mirrored on the device
            if not kind.endswith("CUDA"):
                ann.append((start, end, e.name()))
        elif kind.endswith("CUDA"):
            dev.append((start, end, e.name()))
    dev.sort()
    ann.sort()
    return dev, ann


def union(intervals, t0: int, t1: int):
    """Merged [(start, end)] of sorted intervals, clipped to [t0, t1]."""
    out = []
    for s, e, *_ in intervals:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(intervals, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1] in which some device interval ran."""
    return sum(e - s for s, e in union(intervals, t0, t1))


def top_ops(intervals, n: int = 10):
    """[[kernel name, seconds]] of the n kernels that took most device time."""
    tot = defaultdict(int)
    for s, e, name in intervals:
        tot[name] += e - s
    return [[k[:160], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(intervals, annotations, t0: int, t1: int, n: int = 10):
    """[[host activity, seconds]]: the device's idle time in [t0, t1] summed
    by what the host was doing at each gap's middle."""
    gaps, prev = [], t0
    for s, e in union(intervals, t0, t1):
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if prev < t1:
        gaps.append((prev, t1))
    tot = defaultdict(int)
    j = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while j < len(annotations) and annotations[j][1] < mid:
            j += 1
        label = "runtime (outside execute)"
        if j < len(annotations) and annotations[j][0] <= mid <= annotations[j][1]:
            label = annotations[j][2]
        tot[label] += e - s
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
