"""time_ocean — implicit (theta) time stepping of the ocean (PyTorch
port).

Port of ``iemic_tpu/main/time_ocean.py`` (reference
src/main/time_ocean.C:21-80): reads ``ocean_params.xml``,
``solver_params.xml``, ``ocean_preconditioner_params.xml`` and
``timestepper_params.xml`` from the working directory, runs the adaptive
theta stepper and writes ``tdata.txt``, ``info_0.txt``,
``profile_output`` and, at the "HDF5 output frequency",
``transient_<t>.h5`` states (h5py needed only then).

Usage: python -m iemic_tpu_torch.main.time_ocean [workdir] [--device cuda|cpu]

The default device is cuda; asking for cuda without a card raises.
"""

from __future__ import annotations

import argparse
import os
import sys


def run(workdir: str | None = None, device: str = "cuda"):
    """Time-step the bundle in workdir on device; returns (status, ocean,
    stepper) for callers that inspect the run."""
    from .run_ocean import environment
    from ..config import read_xml
    from ..transient import transient_factory
    from ..utils import logging as log

    with environment(workdir, device, "time_ocean") as ocean:
        log.set_cdata_file("tdata.txt")
        pars = dict(read_xml("timestepper_params.xml").items()) \
            if os.path.exists("timestepper_params.xml") else {}
        stepper = transient_factory(ocean, pars)
        status = stepper.run()
        log.print_profile("profile_output")
        log.set_cdata_file(None)
    return status, ocean, stepper


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="time_ocean")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.workdir, args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
