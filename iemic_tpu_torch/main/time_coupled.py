"""time_coupled — implicit (theta) time stepping of the coupled model
(PyTorch port).

Port of ``iemic_tpu/main/time_coupled.py`` (reference
src/main/time_coupled.C): reads the per-model XML files of run_coupled
plus ``timestepper_params.xml``, builds the coupled
ocean-atmosphere-seaice model and runs the adaptive theta stepper,
writing ``tdata.txt``, ``info_0.txt`` and ``profile_output``.  The
coupled model has no state file of its own, so "HDF5 output frequency"
writes nothing here, as in the JAX package.

Usage:
    python -m iemic_tpu_torch.main.time_coupled [workdir] [--device cuda|cpu]

The default device is cuda; asking for cuda without a card raises.
"""

from __future__ import annotations

import argparse
import os
import sys


def run(workdir: str | None = None, device: str = "cuda"):
    """Time-step the coupled bundle in workdir on device; returns
    (status, coupled model, stepper) for callers that inspect the run."""
    from .run_coupled import coupled_environment
    from ..config import read_xml
    from ..transient import transient_factory
    from ..utils import logging as log

    with coupled_environment(workdir, device, "time_coupled") as coupled:
        log.set_cdata_file("tdata.txt")
        pars = dict(read_xml("timestepper_params.xml").items()) \
            if os.path.exists("timestepper_params.xml") else {}
        stepper = transient_factory(coupled, pars)
        status = stepper.run()
        log.print_profile("profile_output")
        log.set_cdata_file(None)
    return status, coupled, stepper


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="time_coupled")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.workdir, args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
