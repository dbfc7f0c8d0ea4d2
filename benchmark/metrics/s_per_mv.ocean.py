"""Seconds per MV in the ocean's solves: synchronised spans around each
``Ocean.solve``, less the preconditioner builds inside them, over the
solves' MV."""


def read(run):
    mv = run.spans.counted("mv")
    if not mv:
        return None
    return (run.spans.total("solve") - run.spans.total("prec_build")) / mv
