"""Device-to-host reads per MV: the program's counter ``host reads``
(``utils.logging.host``: FGMRES's Hessenberg columns and norms, the
Mixed refinement's and the corrector's norms and dots) over the traced
Newton iteration's MV (``Ocean.solve_iters`` of its solves)."""

from harness import program


def read(run):
    reads, mv = program.counted("host reads"), run.spans.counted("mv")
    return reads / mv if reads is not None and mv else None
