"""Requests that left the last stage inside the window, per second of window."""


def read(ctx):
    return len(ctx["service_s"]) / ctx["window_s"]
