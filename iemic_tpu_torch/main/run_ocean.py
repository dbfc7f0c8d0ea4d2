"""run_ocean — ocean continuation (PyTorch port).

Port of ``iemic_tpu/main/run_ocean.py`` (reference src/main/run_ocean.C):
reads ``ocean_params.xml``, ``continuation_params.xml``,
``solver_params.xml`` and ``ocean_preconditioner_params.xml`` from the
working directory, runs a pseudo-arclength continuation of the ocean
model and writes ``cdata.txt``, ``info_0.txt`` and ``profile_output``.

Usage: python -m iemic_tpu_torch.main.run_ocean [workdir] [--device cuda|cpu]

The default device is cuda; asking for cuda without a card raises.
With a ``jdqz_params.xml`` in the working directory the JDQZ eigensolver
is attached to the continuation, which runs it where
``continuation_params.xml`` asks for eigenvalue analysis ("E" at the end
of the run, "P" at every converged point) and writes ``ev_step_<n>.h5``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch


def initialize_environment():
    """Log to info_0.txt, cdata to cdata.txt, fresh profile, in the
    working directory (reference GlobalDefinitions.C:88
    initializeEnvironment).  Returns (log module, log stream)."""
    from ..utils import logging as log
    stream = open("info_0.txt", "w", buffering=1)   # line-buffered: tail -f
    log.set_log_stream(stream)
    log.set_cdata_file("cdata.txt")
    log.reset_profile()
    return log, stream


def read_solver_params():
    """solver_params.xml with ocean_preconditioner_params.xml merged in
    as its "Preconditioner" sublist."""
    from ..config import read_xml, ParameterList
    solver_params = read_xml("solver_params.xml") \
        if os.path.exists("solver_params.xml") else None
    if os.path.exists("ocean_preconditioner_params.xml"):
        prec = read_xml("ocean_preconditioner_params.xml")
        if solver_params is None:
            solver_params = ParameterList("Solver parameters")
        solver_params.sublist("Preconditioner").update(prec)
    return solver_params


@contextlib.contextmanager
def environment(workdir: str | None, device: str, prog: str):
    """Inside the with block the process works in workdir with the run's
    log files open (info_0.txt, cdata.txt, a fresh profile), and gets the
    bundle's ocean on device, as ocean_params.xml and the solver files
    describe it.  Asking for cuda without a card raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{prog}: --device cuda but no CUDA device")
    cwd = os.getcwd()
    if workdir:
        os.chdir(workdir)
    log, stream = initialize_environment()
    try:
        from ..config import read_xml
        from ..models.ocean import Ocean
        yield Ocean(read_xml("ocean_params.xml"),
                    solver_params=read_solver_params(), device=device)
    finally:
        log.set_log_stream(sys.stdout)
        stream.close()
        os.chdir(cwd)


@contextlib.contextmanager
def bundle(workdir: str | None = None, device: str = "cuda"):
    """Inside the with block the process works in workdir with the run's
    log files open, and gets (ocean, continuation) as the bundle's
    parameter files describe them on device, the JDQZ eigensolver attached
    where there is a ``jdqz_params.xml``."""
    with environment(workdir, device, "run_ocean") as ocean:
        from ..config import read_xml
        from ..continuation import Continuation

        continuation = Continuation(ocean,
                                    read_xml("continuation_params.xml"))
        if os.path.exists("jdqz_params.xml"):
            from ..solvers.eigen import JDQZ
            continuation.set_eigen_solver(
                JDQZ(ocean, read_xml("jdqz_params.xml")))
        yield ocean, continuation


def run(workdir: str | None = None, device: str = "cuda"):
    """Run the bundle in workdir on device; returns (status, ocean,
    continuation) for callers that inspect the run."""
    from ..utils import logging as log
    with bundle(workdir, device) as (ocean, continuation):
        status = continuation.run().status
        log.print_profile("profile_output")
    return status, ocean, continuation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_ocean")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.workdir, args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
