"""The solver factory's host-side builds, Amesos (a sparse LU, scipy's
splu) and MILU (the native multilevel ILU), of the port's row-scaled
Jacobian of the masked global ocean, on this machine's CPU: seconds, the
process's peak resident memory, the stencil's nonzeros and, for Amesos,
the nonzeros of L and U.  Each build runs in a process of its own whose
address space is capped at 60 GiB, so that a build that asks for more
ends with its own error and leaves the machine alone.

    python scripts/host_method_limits.py [--grid N M L]

The grid defaults to the design point, 96x38x12; the sharded solve
gathers its 27*36*l*m*n*8-byte stencil tensor to rank 0 for these two
methods only (iemic_tpu_torch/parallel/methods.py).
"""

import argparse
import os
import resource
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 60 * 2**30


def build(method: str, grid) -> None:
    """One build, in this process: prints its line."""
    import torch
    sys.path.insert(0, REPO)
    from iemic_tpu_torch.main.multichip import DATA, global_thcm
    from iemic_tpu_torch.models.ocean import Ocean
    o = Ocean({"THCM": global_thcm(*grid)}, data_dir=DATA, device="cpu",
              solver_params={"Preconditioning": method,
                             "Precision": "Double"})
    o.compute_rhs()
    o.compute_jacobian()
    nnz = int((o.jac != 0).sum())
    t0 = time.perf_counter()
    f, _ = o._get_prec_factors()
    sec = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    lu = f", L+U nonzeros {f.L.nnz + f.U.nnz}" if method == "Amesos" else ""
    print(f"{method} build at {'x'.join(map(str, grid))} on the host CPU "
          f"({os.cpu_count()} cores, torch threads "
          f"{torch.get_num_threads()}): {sec:.1f} s, peak RSS {rss:.2f} GB, "
          f"stencil nonzeros {nnz}{lu}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, nargs=3, default=(96, 38, 12),
                    metavar=("N", "M", "L"))
    ap.add_argument("--method", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.method:
        build(args.method, args.grid)
        return 0
    for method in ("Amesos", "MILU"):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, __file__, "--method", method, "--grid",
             *map(str, args.grid)], capture_output=True, text=True,
            preexec_fn=lambda: resource.setrlimit(resource.RLIMIT_AS,
                                                  (CAP, CAP)))
        print(f"{method}: exit {p.returncode} after "
              f"{time.perf_counter() - t0:.1f} s (address space capped at "
              f"60 GiB)", flush=True)
        print("\n".join(line for line in p.stdout.splitlines()
                        if not line.startswith("Ocean")), flush=True)
        print(p.stderr[-1500:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
