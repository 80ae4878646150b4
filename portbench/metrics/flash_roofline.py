"""Share (%) of its roofline that the flash-attention kernel reaches in the
profiled slice: the sum over its launches of max(ops / peak, bytes / bandwidth)
(``counts.flash_bound_s``, from the traced batches' shapes) over the sum of
the device time of the kernels named ``flash_fwd_kernel``."""

from portbench import counts

KERNEL = "flash_fwd_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    kernel_s = sum(e - s for s, e, name in tr["device"] if KERNEL in name) / 1e9
    try:
        calls = [
            c
            for b in tr["batches"]
            for c in counts.flash_calls(ctx["archs"](b.stage)[b.variant], b.size,
                                        b.tokens.shape[1], ctx["config"], ctx["root"])
        ]
    except ValueError:
        return None
    launches = sum(1 for *_, name in tr["device"] if KERNEL in name)
    if not calls or kernel_s <= 0 or launches != len(calls):
        return None
    return 100.0 * sum(counts.flash_bound_s(c, ctx["dtype"]) for c in calls) / kernel_s
