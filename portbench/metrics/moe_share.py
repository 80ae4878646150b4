"""Share (%) of the profiled slice that the device spent in MoE layers: the
sum of the ``ms.moe`` attribute (CUDA events at the layers' bounds, from the
post-attention norm to the residual add) of the slice's ``execute`` spans of
``repro_torch.tracing``, over the slice."""

from portbench import spans


def read(ctx):
    execs = spans.executes(ctx)
    if not execs or not any("ms.forward" in s.attrs for s in execs):
        return None
    tr = ctx["trace"]
    moe_ms = sum(s.attrs.get("ms.moe", 0.0) for s in execs)
    return 100.0 * moe_ms * 1e6 / (tr["t1_ns"] - tr["t0_ns"])
