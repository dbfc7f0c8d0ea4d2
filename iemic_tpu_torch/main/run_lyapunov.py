"""run_lyapunov — continuation of a LyapunovModel-wrapped ocean
(PyTorch port).

Port of ``iemic_tpu/main/run_lyapunov.py`` (reference
src/main/run_lyapunov.C): reads ``ocean_params.xml``,
``continuation_params.xml``, ``lyapunov_params.xml`` (and the solver
files) from the working directory, wraps the ocean in
:class:`iemic_tpu_torch.lyapunov.LyapunovModel` and runs a
pseudo-arclength continuation; at each converged point the stationary
covariance of the stochastically forced linearization is solved
(RAILS-equivalent) and its trace and spectrum recorded.  Writes
``lyapunov_data.txt`` (the JAX package's format), ``cdata.txt``,
``info_0.txt`` and ``profile_output``.

Usage: python -m iemic_tpu_torch.main.run_lyapunov [workdir] [--device cuda|cpu]

The default device is cuda; asking for cuda without a card raises.
"""

from __future__ import annotations

import argparse
import os
import sys


def run(workdir: str | None = None, device: str = "cuda"):
    """Run the bundle in workdir on device; returns (status, lyapunov
    model, continuation) for callers that inspect the run."""
    from .run_ocean import environment
    from ..config import read_xml
    from ..continuation import Continuation
    from ..lyapunov import LyapunovModel
    from ..utils import logging as log

    with environment(workdir, device, "run_lyapunov") as ocean:
        lyap_params = dict(read_xml("lyapunov_params.xml").items()) \
            if os.path.exists("lyapunov_params.xml") else {}
        lyap = LyapunovModel(ocean, lyap_params)
        continuation = Continuation(lyap,
                                    read_xml("continuation_params.xml"))
        status = continuation.run().status

        with open("lyapunov_data.txt", "w") as f:
            f.write("#   par          trace        resnorm      its  conv\n")
            for r in lyap.results:
                f.write("%12.6e %12.6e %12.4e %4d %s\n"
                        % (r["par"], r["trace"], r["resnorm"],
                           r["iterations"], r["converged"]))
        log.print_profile("profile_output")
    return status, lyap, continuation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_lyapunov")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.workdir, args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
