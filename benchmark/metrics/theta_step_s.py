"""Wall seconds per unit of work: from the window's start to the end of
the last unit that ended inside it, over the number of those units."""


def read(run):
    return run.unit_s
