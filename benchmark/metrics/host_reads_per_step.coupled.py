"""Device-to-host reads per theta step: the program's counter ``host
reads`` (``utils.logging.host``: the coupled FGMRES's Arnoldi entries and
norms, the inner ocean sweep's, Newton's norms) over the traced steps."""

from harness import program


def read(run):
    reads, n = program.counted("host reads"), len(run.units)
    return reads / n if reads is not None and n else None
