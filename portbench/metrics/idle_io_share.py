"""Share (%) of the profiled slice in which the device was idle inside
``StageServer.execute`` but outside its forward: tokens and stub inputs to
the device, the argmax and the copy to the host (``repro_torch.tracing``'s
``execute`` minus ``execute.forward``)."""

from portbench import spans


def read(ctx):
    split = spans.idle_split(ctx)
    return None if split is None else split["io"]
