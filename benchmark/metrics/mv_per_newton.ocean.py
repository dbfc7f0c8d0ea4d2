"""Inner Krylov iterations (MV) per Newton iteration: ``Ocean``'s
``solve_iters`` summed over the iteration's two solves."""


def read(run):
    n = len(run.units)
    return run.spans.counted("mv") / n if n else None
