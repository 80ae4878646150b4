"""95th percentile over the window's served requests of each request's own
service time: the sum, over its stages, of the wall of the batch that carried it."""

import numpy as np


def read(ctx):
    if not ctx["service_s"]:
        return None
    return float(np.percentile(np.asarray(ctx["service_s"]), 95)) * 1e3
