"""Seconds per traced Newton iteration in synchronised spans around the
ocean's ``compute_rhs`` and ``compute_jacobian`` (F twice for dF/dlambda,
J once, F at the new point)."""


def read(run):
    n = len(run.units)
    return run.spans.total("assembly") / n if n else None
