"""Share (%) of the window's wall spent outside ``StageServer.execute``: the
control loop, the env and the virtual-time runtime. In a traced run the
profiled slice is left out of both sides."""


def read(ctx):
    t0, t1 = ctx["window"]
    inside = sum(max(0.0, min(b.t1, t1) - max(b.t0, t0)) for b in ctx["host_batches"])
    return 100.0 * (1.0 - inside / ctx["host_window_s"])
