"""Share (%) of the profiled slice in which the device was idle while the
program enqueued a stage's forward (inside an ``execute.forward`` span of
``repro_torch.tracing``): the host's launches hold the card back."""

from portbench import spans


def read(ctx):
    split = spans.idle_split(ctx)
    return None if split is None else split["forward"]
