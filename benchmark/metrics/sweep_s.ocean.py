"""Mean seconds of one BGS sweep (the program's synchronised span
``BGS: sweep`` around ``solvers/bgs.apply``) in the traced Newton
iteration, the f32 sweeps of the Mixed solve."""

from harness import program


def read(run):
    s = program.seconds("BGS: sweep")
    return sum(s) / len(s) if s else None
