"""Seconds from the process's start to the window's start: imports, the
kernel build where it is not cached, the model's build and the cell's
own set-up work."""


def read(run):
    return run.setup_s
