"""Mean seconds of one BGS sweep (the program's synchronised span
``BGS: sweep`` around ``solvers/bgs.apply``) in the traced theta step:
the ocean block of the coupled preconditioner, in f64."""

from harness import program


def read(run):
    s = program.seconds("BGS: sweep")
    return sum(s) / len(s) if s else None
