"""Share (%) of the MoE's computed capacity slots that held a token, over
the profiled slice: the sum of ``moe.slots_used`` over the sum of
``moe.slots`` (B x E_phys x C a MoE layer) of the slice's ``execute`` spans
of ``repro_torch.tracing``. The expert FFN runs on every slot, filled or not."""

from portbench import spans


def read(ctx):
    execs = spans.executes(ctx)
    if not execs:
        return None
    slots = sum(s.attrs.get("moe.slots", 0) for s in execs)
    if slots == 0:
        return None
    return 100.0 * sum(s.attrs.get("moe.slots_used", 0) for s in execs) / slots
