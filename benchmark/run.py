"""Run one cell of the port's benchmark once, on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the ``iemic_tpu_torch`` package.  Prints a line per unit of work,
the compared numbers beside their limits on standard error, and as the
last line of standard output one JSON object: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics (``--trace 1``).  Exits
with another code than 0, and prints no result, without a card, outside
such a checkout, or where JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# the top-level names that the program must not bring in; a whole name
# is compared, since the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "iemic_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc library goes to build/kernels by itself)."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "iemic_tpu_torch")) or \
            not os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        print("benchmark: not run from a checkout of the program "
              "(no iemic_tpu_torch/ or BENCHMARK.json beside benchmark/)",
              file=sys.stderr)
        return 2
    _caches()
    sys.path[:0] = [BENCH, ROOT]
    import torch
    from harness import registry, runner

    spec = registry.benchmark(ROOT)
    cell = registry.cell(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    run = runner.run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_process=T_PROCESS,
                          device="cuda", spec=spec)
    print(f"cell {args.workload} seed {args.seed}: {run.describe}; "
          f"set-up {run.setup_s!r} s, of which the kernel build "
          f"{run.build_s!r} s", flush=True)
    for i, ((a, b), (now, peak)) in enumerate(zip(run.units, run.memory)):
        inside = "in the window" if (a, b) in run.done else "past the window"
        print(f"unit {i}: {b - a!r} s, ends at {b!r} s, {inside}; "
              f"allocated {now} bytes, peak {peak} bytes", flush=True)
    if run.trace:
        print(f"trace: {run.trace_summary['activities']} events, "
              f"busy {run.trace_summary['busy_s']!r} s of "
              f"{run.trace_summary['window_s']!r} s", flush=True)
    if not run.done:
        print("benchmark: no unit ended inside the window", file=sys.stderr)
        return 3
    line = runner.result(run, spec)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 4
    for k, v in line["checks"].items():
        ok = "ok" if v["value"] <= v["limit"] else "FAILS"
        print(f"check {k} {v['value']!r} limit {v['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
