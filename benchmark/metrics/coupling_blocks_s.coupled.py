"""Seconds per theta step assembling the coupling blocks: the program's
synchronised span ``CoupledModel: coupling blocks`` (the forward-mode
probes of ``CoupledModel._block``) summed over the traced steps."""

from harness import program


def read(run):
    s, n = program.seconds("CoupledModel: coupling blocks"), len(run.units)
    return sum(s) / n if s is not None and n else None
