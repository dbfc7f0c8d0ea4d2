"""run_topo — topography homotopy continuation over a mask sequence
(PyTorch port).

Port of ``iemic_tpu/main/run_topo.py`` (reference
src/main/run_topo.C:19-90): reads ``ocean_params.xml``,
``topo_params.xml``, ``continuation_params.xml`` (and optionally
``solver_params.xml`` and ``ocean_preconditioner_params.xml``) from the
working directory, then for each consecutive pair of land masks runs a
pseudo-arclength continuation in "Delta" from 0 to 1, deforming the
steady state from one topography to the next.  Writes ``cdata.txt``,
``info_0.txt`` and ``profile_output``.

The mask files that ``topo_params.xml`` names are searched in the working
directory, then under ``<Data directory>/mkmask``, and
``continuation_params.xml`` must continue in "Delta": the shipped
``run/topo`` bundle names files that do not exist and continues in
"Combined Forcing", where the state stays at x_A (ROADMAP queue 3).

Usage: python -m iemic_tpu_torch.main.run_topo [workdir] [--device cuda|cpu]

The default device is cuda; asking for cuda without a card raises.
"""

from __future__ import annotations

import argparse
import sys


def run(workdir: str | None = None, device: str = "cuda"):
    """Run the mask homotopy of the bundle in workdir on device; returns
    (status, topo, continuation) for callers that inspect the run."""
    from .run_ocean import environment
    from ..config import read_xml
    from ..continuation import Continuation
    from ..topo import Topo
    from ..utils import logging as log

    with environment(workdir, device, "run_topo") as ocean:
        topo = Topo(ocean, read_xml("topo_params.xml"))
        continuation = Continuation(topo,
                                    read_xml("continuation_params.xml"))
        status = 0
        for mask_idx in range(topo.start_mask, topo.n_masks - 1):
            topo.set_mask_index(mask_idx)
            topo.initialize()

            with log.timer("TOPO: Predictor"):
                topo.predictor()

            with log.timer("TOPO: Homotopy Continuation"):
                status = continuation.run().status
            if status != 0:
                log.WARNING(f"topo leg {mask_idx} failed: {status}")
                break

            topo.set_par("Delta", 1.0)
            topo.post_process()

        log.print_profile("profile_output")
    return status, topo, continuation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_topo")
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    return run(args.workdir, args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
