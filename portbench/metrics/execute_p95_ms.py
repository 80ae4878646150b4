"""95th percentile of one batch's wall inside ``StageServer.execute`` (host
clock; ``execute`` ends with its copy to the host), outside any profiled slice."""

import numpy as np


def read(ctx):
    walls = [b.t1 - b.t0 for b in ctx["host_batches"]]
    return float(np.percentile(np.asarray(walls), 95)) * 1e3 if walls else None
