"""The coupled FGMRES iterations of the traced theta step, summed over
its solves."""


def read(run):
    n = len(run.units)
    return run.spans.counted("mv") / n if n else None
