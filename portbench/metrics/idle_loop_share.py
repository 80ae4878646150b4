"""Share (%) of the profiled slice in which the device was idle outside
every ``execute`` span of ``repro_torch.tracing``: the control loop, the env
and the virtual-time runtime between batches."""

from portbench import spans


def read(ctx):
    split = spans.idle_split(ctx)
    return None if split is None else split["loop"]
