"""CUDA graphs recorded per Newton iteration: the program's counter
``graphs recorded`` (one per ``solvers/bgs._Graphed``) over the spans
``Continuation: Newton iteration`` of the traced window."""

from harness import program


def read(run):
    newton = program.spans("Continuation: Newton iteration")
    if not newton:
        return None
    return program.counted("graphs recorded") / len(newton)
