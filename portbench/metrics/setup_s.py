"""Seconds from the process's start to the window: imports, the kernels'
build or load, the stage servers and their weights, the warm-up serve."""


def read(ctx):
    return ctx["setup_s"]
