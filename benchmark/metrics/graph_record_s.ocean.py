"""Seconds per Newton iteration spent recording the sweep's CUDA graphs:
the program's synchronised span ``BGS: record graphs`` (warm-up and
capture in ``solvers/bgs._Graphed``) summed, over the spans
``Continuation: Newton iteration`` of the traced window."""

from harness import program


def read(run):
    newton = program.spans("Continuation: Newton iteration")
    if not newton:
        return None
    return sum(program.seconds("BGS: record graphs")) / len(newton)
