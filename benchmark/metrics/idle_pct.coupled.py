"""Share of the traced window in which no kernel, copy or memset ran on
the device (the union of the profiler's device intervals), in percent."""


def read(run):
    s = run.trace_summary
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
