"""Newton iterations of the traced theta step (the stepper's NR)."""


def read(run):
    n = len(run.units)
    return run.spans.counted("newton") / n if n else None
