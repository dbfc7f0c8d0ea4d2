"""run_coupled — coupled ocean-atmosphere(-seaice) continuation (PyTorch
port).

Port of ``iemic_tpu/main/run_coupled.py`` (reference
src/main/run_coupled.C:35-130): reads ``ocean_params.xml``,
``atmosphere_params.xml``, ``seaice_params.xml``,
``coupledmodel_params.xml``, ``continuation_params.xml``,
``solver_params.xml`` and ``ocean_preconditioner_params.xml`` from the
working directory, builds the coupled model and runs the continuation
(with the JDQZ eigensolver attached where there is a
``jdqz_params.xml``), writing ``cdata.txt``, ``info_0.txt`` and
``profile_output``.

Usage: python -m iemic_tpu_torch.main.run_coupled [workdir] [--device cuda|cpu]

The default device is cuda; asking for cuda without a card raises.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys


@contextlib.contextmanager
def coupled_environment(workdir: str | None, device: str, prog: str):
    """run_ocean.environment for a coupled bundle: inside the with block
    the process works in workdir with the run's log files open, and gets
    the bundle's CoupledModel on device."""
    from .run_ocean import environment
    from ..models.coupled import build_coupled_from_files
    with environment(workdir, device, prog) as ocean:
        yield build_coupled_from_files(device=device, ocean=ocean)


def run(workdir: str | None = None, device: str = "cuda"):
    """Run the coupled bundle in workdir on device; returns (status,
    coupled model, continuation) for callers that inspect the run."""
    from ..config import read_xml
    from ..continuation import Continuation
    from ..utils import logging as log

    with coupled_environment(workdir, device, "run_coupled") as coupled:
        continuation = Continuation(coupled,
                                    read_xml("continuation_params.xml"))
        if os.path.exists("jdqz_params.xml"):
            from ..solvers.eigen import JDQZ
            continuation.set_eigen_solver(
                JDQZ(coupled, read_xml("jdqz_params.xml")))
        status = continuation.run().status
        log.print_profile("profile_output")
        log.set_cdata_file(None)
    return status, coupled, continuation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_coupled")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.workdir, args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
