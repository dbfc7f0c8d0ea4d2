"""Seconds per traced theta step in synchronised spans around the coupled
model's ``compute_rhs`` and ``compute_jacobian``."""


def read(run):
    n = len(run.units)
    return run.spans.total("assembly") / n if n else None
