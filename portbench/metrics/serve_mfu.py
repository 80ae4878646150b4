"""Share (%) of the card's dense peak that the window's stage forwards use:
their operations (``counts.forward_flops``, from the batches' shapes) over the
window's wall times the peak of the configuration's dtype. Batches that ended
after the window and a traced run's profiled slice are left out."""

from portbench import counts


def read(ctx):
    t0, t1 = ctx["window"]
    done = [b for b in ctx["host_batches"] if b.t1 <= t1]
    try:
        ops = sum(
            counts.forward_flops(ctx["archs"](b.stage)[b.variant], b.size, b.tokens.shape[1],
                                 ctx["config"], ctx["root"])
            for b in done
        )
    except ValueError:
        return None
    return 100.0 * ops / (ctx["host_window_s"] * counts.PEAK_FLOPS[ctx["dtype"]])
