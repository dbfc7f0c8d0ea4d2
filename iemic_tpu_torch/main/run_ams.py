"""run_ams — rare-event (AMS/TAMS/GPA) transitions between states
(PyTorch port).

Port of ``iemic_tpu/main/run_ams.py`` (reference src/main/run_ams.C:25-100):
loads the states A and B (and optionally an unstable state D) from HDF5
files (h5py needed), builds a stochastic theta stepper with a score
function, runs the method that ``ams_params.xml`` names and reports the
transition probability and the mean first passage time.

Usage: python -m iemic_tpu_torch.main.run_ams [workdir] [--device cuda|cpu]

The default device is cuda; asking for cuda without a card raises.
"""

from __future__ import annotations

import argparse
import os
import sys


def run(workdir: str | None = None, device: str = "cuda",
        states: dict | None = None):
    """Run the rare-event method of the bundle in workdir on device;
    returns (status, ocean, method) for callers that inspect the run.
    states maps "solution 1", "solution 2" and "solution 3" to flat
    numpy states held in memory, which take the place of the files that
    ams_params.xml names (on a machine without h5py)."""
    from .run_ocean import environment
    from ..config import read_xml
    from ..transient import transient_factory
    from ..utils import hdf5 as h5
    from ..utils import logging as log

    with environment(workdir, device, "run_ams") as ocean:
        log.set_cdata_file("tdata.txt")
        pars = dict(read_xml("ams_params.xml").items())

        held = dict(states or {})

        def load(key, default):
            state = held.get(key)
            if state is None:
                name = pars.get(key, default)
                if key == "solution 3" and not (name and os.path.exists(name)):
                    return None
                state, _ = h5.load_state(name)
                if state is None:
                    raise FileNotFoundError(name)
            return ocean.from_flat(ocean._tensor(state))

        sol1 = load("solution 1", "sol1.h5")
        sol2 = load("solution 2", "sol2.h5")
        sol3 = load("solution 3", "")

        pars.setdefault("score function", "ocean")
        method = transient_factory(ocean, pars, sol1=sol1, sol2=sol2,
                                   sol3=sol3)
        status = method.run()
        log.INFO(f"probability = {method.get_probability()}")
        log.INFO(f"mfpt        = {method.get_mfpt()}")
        log.print_profile("profile_output")
        log.set_cdata_file(None)
    return status, ocean, method


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_ams")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.workdir, args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
