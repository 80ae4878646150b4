"""Share (%) of the profiled slice in which no kernel, copy or set ran on the
device: 1 - (union of the device intervals) / (the slice)."""

from portbench import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["device"]:
        return None
    busy = trace.busy_ns(tr["device"], tr["t0_ns"], tr["t1_ns"])
    return 100.0 * (1.0 - busy / (tr["t1_ns"] - tr["t0_ns"]))
