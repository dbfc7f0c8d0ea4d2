"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --general-kernel   # and the main phase once
                                     # more through the general-shape kernel

Phases, each printing its own line:
  1. device   — the card's name and power limit (nvidia-smi); TF32 off
  2. build    — nvcc builds the stencil kernels from iemic_tpu_torch/csrc
  3. kernel   — every entry point of the kernel library against the
                plain PyTorch version, periodic and not, f32 and bf16
                coefficients: the wide kernels on the global 96x38x12
                grid, the general-shape kernels at 12x38x97 and 6x6x3;
                each also on an x kept on the two edge columns in i;
                CUDA-event times beside the bound (the bytes of the
                coefficients whose neighbour lies in the grid, of x and
                of y, over 3.35 TB/s) and one read of all coefficients
                by PyTorch
  4. assembly — F and the f64 stencil tensor An of the global grid
                computed on the card against the port on the CPU
  5. effort   — one production solve (BGS + Mixed, tol 1e-3) of the
                configuration whose effort TESTLOG.md:139 records for
                the JAX package (69 MV to relres 6.92e-4): the port must
                meet the tolerance with MV within 10% of that record;
                then both f32 kernels on that model's own Jacobian and
                the solve's vectors against the f64 product
  6. variants — on the effort phase's model and Jacobian, one Mixed
                solve of J x = -F at tol 1e-3, capped at 150 inner
                iterations, for each other branch of the BGS sweep
                (saddle schemes SL, SR and KRYLOV, symmetric
                Gauss-Seidel, the rho/mu transform, orderings M2 and M3,
                Columns on ATS, MG on Auv and on the 2D saddle,
                piecewise-constant MG prolongation): MV, true relative
                residual, seconds, kernel launches; a variant that stalls
                short of 1e-3 is printed as such, one whose output is not
                finite or whose residual is not below 1 fails.  Then Teko,
                MILU and Amesos on the masked 8x8x4 grid, CUDA tensors
                through the host-side factorizations
  7. eigen    — JDQZ as run_ocean attaches it (jdqz_params.xml, real
                shift 0: shift-invert Arnoldi whose every step is a Mixed
                Ocean.solve): a run_ocean run with eigenvalue analysis on
                a 4x4x3 basin, whose pairs are held to the solver's limit
                on the true pencil residual and to the dense spectrum;
                then the analysis at 96x38x12, every solve held to 150
                inner iterations, over one search space of 16 and, the
                bound widened once, one restart: the Ritz values, which
                pairs converged if any, each pair's true pencil residual,
                solves, MV and launches; F and An unchanged to the bit
                after both; and a solve with the shifted pencil J - 0.1 B
                at 96x38x12
  8. main     — run_ocean on a copy of run/ocean/global (BGS + Mixed)
                on the card, cut to one continuation step of three
                Newton iterations at FGMRES tolerance 5e-2; checks the
                exit status, that every kernel launch went through the
                wide f32 kernel, falling |F| and every solve's true
                relative residual (< the tolerance, so < 1)

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Any failed check raises (exit code 1).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(REPO, "run", "ocean", "global")
# |kernel - plain| <= KTOL * max|plain|: both accumulate in f32, in
# another order
KTOL = 2e-5
# published peaks of one H100 SXM: device memory rate, and the f32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# F and An on the card against the CPU, max-norm scaled
ATOL = 1e-12
# the JAX package's effort on the effort phase's configuration
# (TESTLOG.md:139, variant spp60@1e-8): MV and relres at tol 1e-3
EFFORT_TOL = 1e-3
EFFORT_MV = 69
# the variants phase: inner iterations allowed to one solve, and how far
# the true residual may lie above the one the solve reports (both are
# the f64 residual of the same row-scaled system)
VARIANT_CAP = 150
RELRES_MARGIN = 1.01
# BGS settings that differ from the bundle's, each with the inner
# iterations its solve may take.  "Auv Precond" acts only where the sweep
# has a separate momentum solve (scheme KRYLOV, M2, M3).  Orderings M2
# and M3 put the SIMPLE sweep with its inner Chat FGMRES inside the 2D
# saddle's 60-iteration FGMRES, eager: about 4.3 s a sweep on the card,
# so they get 6 iterations.
VARIANTS = [
    ("scheme SL", {"Saddlepoint scheme": "SL"}, VARIANT_CAP),
    ("symmetric Gauss-Seidel", {"Scheme": "symmetric Gauss-Seidel"},
     VARIANT_CAP),
    ("rho/mu transform", {"ATS rho/mu Transform": True}, VARIANT_CAP),
    ("permutation 2", {"Permutation": 2}, 6),
    ("permutation 3", {"Permutation": 3}, 6),
    ("ATS Columns", {"ATS Precond": "Columns"}, VARIANT_CAP),
    ("scheme KRYLOV, Auv MG", {"Saddlepoint scheme": "KRYLOV",
                               "Auv Precond": "MG"}, VARIANT_CAP),
    ("scheme KRYLOV, saddle Jacobi", {"Saddlepoint scheme": "KRYLOV",
                                      "Saddlepoint Precond": "Jacobi"},
     VARIANT_CAP),
    ("MG prolongation weight 0", {"MG prolongation weight": 0.0},
     VARIANT_CAP),
]
# Two branches whose sweep is not finite on the masked global grid, in the
# JAX package as in the port (tests/test_torch_bgs_unbounded.py holds the
# two packages' sweeps together at 32x16x8): SIMPLER's second Chat V-cycle
# squares the gain of the coarsest level's 1e-12 shift (max |z| of order
# 1e23, past what an f32 inner FGMRES can square), and the point blocks
# of the 2D saddle's multigrid smoother are singular where the pressure
# has no centre coefficient.  At 96x38x12 the phase prints one sweep of
# each; their solve runs on the masked 8x8x4 grid.
SMALL_GRID_VARIANTS = [
    ("scheme SR", {"Saddlepoint scheme": "SR"}),
    ("scheme KRYLOV, saddle MG", {"Saddlepoint scheme": "KRYLOV",
                                  "Saddlepoint Precond": "MG"}),
]
ISLAND = {
    "Global Grid-Size n": 8, "Global Grid-Size m": 8,
    "Global Grid-Size l": 4, "Read Land Mask": True,
    "Land Mask": "test8x8x4_3",
    "Starting Parameters": {"Combined Forcing": 0.5,
                            "Temperature Forcing": 10.0,
                            "Salinity Forcing": 0.1, "Wind Forcing": 1.0}}
# the masked global grid of the effort, variants and eigen phases, at the
# state whose solve the repo records (scripts/diagnose.py sweep)
GLOBAL_THCM = {
    "Global Grid-Size n": 96, "Global Grid-Size m": 38,
    "Global Grid-Size l": 12,
    "Global Bound xmin": 0.0, "Global Bound xmax": 360.0,
    "Global Bound ymin": -85.5, "Global Bound ymax": 85.5,
    "Periodic": True, "Read Land Mask": True,
    "Land Mask": "mask_global_96x38x12",
    "Starting Parameters": {"Combined Forcing": 0.1,
                            "Temperature Forcing": 10.0,
                            "Wind Forcing": 1.0,
                            "Salinity Forcing": 0.1}}
# the eigen phase's jdqz_params.xml.  "Solver tolerance" is the tightest
# the shift-invert solves are asked for.  The search space of 16 is the
# first bound on the analysis; "Max JD iterations" 17 lets it restart
# once (Krylov-Schur, keeping 4 vectors) and fill the space again, 28
# steps in all: the bound widened once
JDQZ_PARAMS = {"Shift (real part)": 0.0, "Shift (imaginary part)": 0.0,
               "Number of eigenvalues": 2, "Tolerance": 1e-4,
               "Max size search space": 16, "Max JD iterations": 17,
               "Solver tolerance": 1e-3}
# the kernel of the main path: the bundle's f32 coefficients on its
# 96x38x12 grid take the wide kernel
MAIN_ENTRY = "stencil_matvec_f32_wide"
# FGMRES tolerance and Newton iterations of the main phase (see
# _bundle_copy)
SOLVE_TOL = 5e-2
NEWTON_ITERS = 3


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fns, reps: int = 21, batches: int = 5) -> float:
    """Device time of one call.  fns are calls of one function on
    separate copies of its large input, taken in turn, so that no call
    finds in the 50 MB L2 what the call before it read (the solver's
    calls are a whole preconditioner sweep apart).  reps calls are
    recorded into one CUDA graph, so that the host's enqueue, which takes
    longer than the fast kernels, is not timed; CUDA events around a
    replay, over reps; the median of batches replays."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fns[r % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def needed_coefficients(l: int, m: int, n: int, periodic: bool) -> int:
    """Coefficients of the 972 * l*m*n whose neighbour lies in the grid:
    the others multiply a zero and need not be read."""
    return 36 * (3 * l - 2) * (3 * m - 2) * (3 * n if periodic
                                             else 3 * n - 2)


def bound_ms(itemsize: int, l: int, m: int, n: int,
             periodic: bool) -> tuple[float, str]:
    """The least time the card could take for one matvec: the larger of
    the bytes it must move (the needed coefficients and x read once, y
    written once) over the memory rate and its two operations per needed
    coefficient over the f32 rate; and which of the two it is."""
    need = needed_coefficients(l, m, n, periodic)
    t_bytes = (need * itemsize + 2 * 6 * l * m * n * 4) / HBM_BYTES_PER_S
    t_ops = 2 * need / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def _check_kernel(hopper, AnK, x, periodic, what):
    """One launch against the plain version; returns (error, scale)."""
    y = hopper.apply_stencil_prepared(AnK, x, periodic=periodic)
    ref = hopper.apply_plain(AnK, x, periodic=periodic)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    if not (bool(torch.isfinite(y).all()) and err <= KTOL * scale):
        raise AssertionError(f"kernel {what} periodic={periodic} "
                             f"disagrees: {err:.3e} (limit {KTOL:.0e} x "
                             f"{scale:.3e})")
    return err, scale


def phase_kernel(hopper, card_line: str) -> dict:
    """Every entry point of the kernel library against the plain PyTorch
    version: the wide kernels at the global grid's shape, the
    general-shape kernels at shapes the wide ones refuse (a row of 97,
    and the 2DMOC fixture's 6x6x3), periodic and not, with a random x
    and with an x kept on the two edge columns in i, where a wrong wrap
    or zero boundary shows in every term.  Returns the record of each
    entry point at its first shape, periodic (the bundle's setting)."""
    rec = {}
    for l, m, n in ((12, 38, 96), (12, 38, 97), (6, 6, 3)):
        g = torch.Generator(device="cuda").manual_seed(0)
        An = torch.randn((27, 6, 6, l, m, n), generator=g, device="cuda",
                         dtype=torch.float64)
        # f32, as the Krylov loop hands it over
        x = torch.randn((6, l, m, n), generator=g, device="cuda",
                        dtype=torch.float32)
        edge = torch.zeros_like(x)
        edge[..., 0], edge[..., -1] = x[..., 0], x[..., -1]
        for dtype in (torch.float32, torch.bfloat16):
            AnK = hopper.prepare(An, dtype)
            entry = hopper.kernel_variant(dtype, l, m, n)
            copies = [AnK, AnK.clone(), AnK.clone()]     # see time_ms
            for periodic in (False, True):
                bound, bound_by = bound_ms(AnK.element_size(), l, m, n,
                                           periodic)
                need = needed_coefficients(l, m, n, periodic) \
                    * AnK.element_size()
                before = hopper.LAUNCHES_BY_ENTRY[entry]
                err, scale = _check_kernel(hopper, AnK, x, periodic, entry)
                eerr, escale = _check_kernel(hopper, AnK, edge, periodic,
                                             entry + " (edge columns)")
                if hopper.LAUNCHES_BY_ENTRY[entry] != before + 2:
                    raise AssertionError(f"{entry} was not the kernel "
                                         f"launched at {(l, m, n)}")
                ms = time_ms([lambda a=a: hopper.apply_stencil_prepared(
                    a, x, periodic=periodic) for a in copies])
                plain_ms = time_ms([lambda a=a: hopper.apply_plain(
                    a, x, periodic=periodic) for a in copies])
                print(f"kernel {entry} periodic={periodic} "
                      f"shape=(27,6,6,{l},{m},{n}) max_abs_err={err:.3e} "
                      f"(limit {KTOL:.0e} x {scale:.3e}) edge columns "
                      f"{eerr:.3e} (x {escale:.3e}) kernel {ms:.4f} ms "
                      f"plain {plain_ms:.4f} ms bound {bound:.4f} ms by "
                      f"{bound_by} ({100 * bound / ms:.0f}% of bound; "
                      f"{need} coefficient bytes needed) "
                      f"[{card_line}]", flush=True)
                if periodic and entry not in rec:
                    rec[entry] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=bound_by, library_ms=None)
            if (l, m, n) == (12, 38, 96):
                # what the card's memory gives in practice: one read of
                # all coefficients, the skipped ones too, by a PyTorch
                # reduction (it does not compute the kernel's function)
                read_ms = time_ms([lambda a=a: a.sum() for a in copies])
                nbytes = AnK.numel() * AnK.element_size()
                print(f"kernel read of all {nbytes} coefficient bytes by "
                      f"AnK.sum() ({entry}'s input): {read_ms:.4f} ms, "
                      f"{nbytes / read_ms * 1e-9:.3f} TB/s; the kernel, "
                      f"periodic: {need / rec[entry]['ms'] * 1e-9:.3f} TB/s "
                      f"of needed coefficient bytes [{card_line}]",
                      flush=True)
            del AnK, copies
    if set(rec) != set(hopper.ENTRIES):
        raise AssertionError(f"entry points not exercised: "
                             f"{set(hopper.ENTRIES) - set(rec)}")
    return rec


def phase_assembly() -> None:
    """F and An of the global grid: card against CPU, same state."""
    from iemic_tpu_torch.config import read_xml
    from iemic_tpu_torch.models.ocean import Ocean
    from iemic_tpu_torch import interop

    oceans = [Ocean(read_xml(os.path.join(BUNDLE, "ocean_params.xml")),
                    data_dir=os.path.join(REPO, "data"), device=d)
              for d in ("cuda", "cpu")]
    rng = np.random.default_rng(1)
    x = 0.05 * rng.standard_normal(tuple(oceans[0].state.shape))
    x[4] += np.linspace(1.0, -1.0, x.shape[1])[:, None, None]
    out = []
    for o in oceans:
        interop.install_state(o, x)
        t0 = time.perf_counter()
        o.compute_rhs()
        o.compute_jacobian()
        if o.device.type == "cuda":
            torch.cuda.synchronize()
        out.append((o.rhs.cpu(), o.jac.cpu(), time.perf_counter() - t0))
    for name, i in (("F", 0), ("An", 1)):
        ref = out[1][i]
        err = float((out[0][i] - ref).abs().max() / ref.abs().max())
        print(f"assembly {name} shape={tuple(ref.shape)} cuda-vs-cpu "
              f"relative max error {err:.3e} (limit {ATOL:.0e})",
              flush=True)
        if not (err <= ATOL and torch.isfinite(out[0][i]).all()):
            raise AssertionError(f"assembly {name} disagrees: {err:.3e}")
    print(f"assembly wall: cuda {out[0][2]:.3f} s, cpu {out[1][2]:.3f} s "
          "(rhs + Jacobian, first call)", flush=True)


def _check_model_operator(hopper, o, vectors) -> None:
    """The wide and the general-shape f32 kernel on the model's own
    masked Jacobian and vectors of its solve, against the f64 product.
    Each output row A is held to KTOL times the largest sum of |terms|
    of that row, which is what bounds an f32 sum's round-off: the rows
    differ by orders of magnitude, and terms cancel."""
    from iemic_tpu_torch.ops.stencil import apply_stencil
    An = o.jac
    _, _, _, l, m, n = An.shape
    AnK = hopper.prepare(An)
    periodic = o.cfg.periodic
    for name, v in vectors:
        x = v.reshape(6, l, m, n).float()
        # the same values 4 bytes off a 16-byte boundary: the wrapper
        # then takes the general-shape kernel
        off = torch.empty(x.numel() + 1, device=x.device,
                          dtype=x.dtype)[1:].view_as(x).copy_(x)
        before = dict(hopper.LAUNCHES_BY_ENTRY)
        wide = hopper.apply_stencil_prepared(AnK, x, periodic=periodic)
        general = hopper.apply_stencil_prepared(AnK, off, periodic=periodic)
        if (hopper.LAUNCHES_BY_ENTRY[MAIN_ENTRY] != before[MAIN_ENTRY] + 1
                or hopper.LAUNCHES_BY_ENTRY["stencil_matvec_f32"]
                != before["stencil_matvec_f32"] + 1):
            raise AssertionError("model operator: not the two f32 kernels")
        plain = hopper.apply_plain(AnK, x, periodic=periodic)
        AnK64, x64 = AnK.double(), x.double()
        ref = apply_stencil(AnK64, x64, periodic=periodic)
        # a row of zeros has error 0 over scale 0
        scale = apply_stencil(AnK64.abs(), x64.abs(), periodic=periodic
                              ).amax(dim=(1, 2, 3)).clamp_min(1e-300)
        errs = {k: (y.double() - ref).abs().amax(dim=(1, 2, 3)) / scale
                for k, y in (("wide", wide), ("general", general),
                             ("plain", plain))}
        print(f"effort model operator x={name} periodic={periodic}: error "
              "against the f64 product over the row's largest sum of "
              "|terms|, rows A=0..5: " + "; ".join(
                  f"{k} " + " ".join(f"{e:.2e}" for e in v.tolist())
                  for k, v in errs.items())
              + f" (limit {KTOL:.0e}); wide and general differ in "
              f"{int((wide != general).sum())} of {wide.numel()} values",
              flush=True)
        for k in ("wide", "general"):
            if not bool((errs[k] <= KTOL).all()):
                raise AssertionError(f"{k} kernel disagrees on the model's "
                                     f"operator, x={name}: {errs[k]}")


def phase_effort(hopper, card_line: str):
    """The production solve of scripts/diagnose.py's sweep (the masked
    global grid at its initial state, Combined Forcing 0.1, default BGS
    parameters, Mixed, tol 1e-3, b = -F), whose MV the repo records for
    the JAX package: the port's preconditioner must do as well.  Returns
    the model, with F and the Jacobian of that state."""
    from iemic_tpu_torch.models.ocean import Ocean

    o = Ocean({"THCM": dict(GLOBAL_THCM)},
        solver_params={"Preconditioning": "BGS", "Precision": "Mixed",
                       "FGMRES tolerance": EFFORT_TOL,
                       "FGMRES iterations": 200},
        data_dir=os.path.join(REPO, "data"), device="cuda")
    o.compute_rhs()
    o.compute_jacobian()
    t0 = time.perf_counter()
    dx = o.solve(-o.rhs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mv, relres = o.solve_iters, o.solve_relres
    print(f"effort MV {mv} relres {relres:.3e} in {wall:.3f} s (JAX record "
          f"{EFFORT_MV} MV to 6.92e-4, tol {EFFORT_TOL:g}) [{card_line}]",
          flush=True)
    if not (relres < EFFORT_TOL and abs(mv - EFFORT_MV) <= 0.1 * EFFORT_MV):
        raise AssertionError(f"effort: {mv} MV to {relres:.3e}; the JAX "
                             f"package needs {EFFORT_MV} MV to reach "
                             f"{EFFORT_TOL:g}")
    _check_model_operator(hopper, o, (("-F", -o.rhs), ("dx", dx)))
    return o


def _set_solver(o, prec: dict, **solver) -> None:
    """Give the model another solver configuration, keeping its state, F
    and Jacobian; the factors are rebuilt at the next solve."""
    from iemic_tpu_torch.config import ParameterList
    from iemic_tpu_torch.models.ocean.ocean import default_solver_params
    sp = ParameterList("solver", dict(
        {"Preconditioning": "BGS", "Precision": "Mixed",
         "FGMRES tolerance": EFFORT_TOL, "FGMRES iterations": 200},
        Preconditioner=dict(prec), **solver))
    sp.validate_and_set_defaults(default_solver_params())
    o.solver_params = sp
    o._build_solver()


def _true_relres(o, x, b) -> float:
    """||P (R b - R J x)|| / ||P R b|| in f64: the row-scaled, deflated
    system the solve works on, computed apart from it."""
    from iemic_tpu_torch.models.ocean.ocean import _proj
    nullq = o._get_deflator()
    flat_b = _proj((b * o._rowscale).reshape(-1), nullq)
    r = flat_b - o._mv64(x.reshape(-1), nullq)
    return float(torch.linalg.norm(r) / torch.linalg.norm(flat_b))


def _capped_solve(o, b, cap: int):
    """o.solve(b) with the Mixed path held to cap inner Krylov iterations
    in all: each f32 inner solve gets what is left of cap, an exhausted
    budget returns a zero correction, which ends the refinement loop, and
    the GMRES-IR tail (up to 120 outer iterations of full inner solves)
    is given no outer iteration.  A solve that converges within cap never
    meets any of this."""
    inner, tail, maxiter = o._inner, o._gmres_ir_host, o._maxiter
    used = [0]

    def capped_inner(factors32, r, nullq, tol):
        left = cap - used[0]
        if left <= 0:
            return torch.zeros_like(r), 0, 1.0
        o._maxiter = min(maxiter, left)
        dz, its, relres = inner(factors32, r, nullq, tol)
        used[0] += its
        return dz, its, relres

    o._inner = capped_inner
    o._gmres_ir_host = lambda *a: tail(*a, maxouter=0)
    try:
        return type(o).solve(o, b)
    finally:
        o._inner, o._gmres_ir_host, o._maxiter = inner, tail, maxiter


def _variant_solve(hopper, o, b, name, prec, cap, card_line, where=""):
    """One capped Mixed solve of J x = b with the BGS settings prec."""
    _set_solver(o, prec)
    before = hopper.LAUNCHES
    t0 = time.perf_counter()
    x = _capped_solve(o, b, cap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hopper.LAUNCHES - before
    true = _true_relres(o, x, b)
    verdict = "converged" if true < EFFORT_TOL else \
        f"stalled short of {EFFORT_TOL:g}"
    print(f"variant {name}{where}: MV {o.solve_iters} (at most {cap}) true "
          f"relres {true:.3e} (the solve reports {o.solve_relres:.3e}) in "
          f"{wall:.3f} s, {launches} kernel launches: {verdict} "
          f"[{card_line}]", flush=True)
    finite = bool(torch.isfinite(x).all())
    if not (finite and true < 1.0 and launches > 0
            and true <= RELRES_MARGIN * o.solve_relres + 1e-14):
        raise AssertionError(f"variant {name} failed: finite {finite}, "
                             f"true relres {true:.3e}, reported "
                             f"{o.solve_relres:.3e}, {launches} launches")


def _small_ocean(solver_params: dict):
    """The masked 8x8x4 grid on the card, with F and the Jacobian."""
    from iemic_tpu_torch.models.ocean import Ocean
    s = Ocean({"THCM": dict(ISLAND)}, solver_params=solver_params,
              data_dir=os.path.join(REPO, "data"), device="cuda")
    s.compute_rhs()
    s.compute_jacobian()
    return s


def phase_variants(hopper, o, card_line: str) -> None:
    """Every BGS branch the bundle does not take, on the effort phase's
    model, F and Jacobian; then what only a small grid can run: the two
    branches whose sweep is not finite at that size, and the factory's
    other methods."""
    b = -o.rhs
    for name, prec, cap in VARIANTS:
        _variant_solve(hopper, o, b, name, prec, cap, card_line)

    small = _small_ocean({"Preconditioning": "BGS", "Precision": "Mixed"})
    for name, prec in SMALL_GRID_VARIANTS:
        _set_solver(o, prec)
        f64, f32 = o._get_prec_factors()
        r = b * o._rowscale
        z64 = o._prec_apply(f64, r)
        z32 = o._prec_apply(f32, r.float())
        print(f"variant {name} at 96x38x12, one sweep of -F: f64 finite "
              f"{bool(torch.isfinite(z64).all())}, max |z| "
              f"{float(z64.abs().max()):.3e}; f32 finite "
              f"{bool(torch.isfinite(z32).all())} (its solve runs on the "
              "small grid)", flush=True)
        _variant_solve(hopper, small, -small.rhs, name, prec, VARIANT_CAP,
                       card_line, " (masked 8x8x4)")
    _set_solver(o, {})

    # MILU and Amesos factor and solve on the host, so every application
    # carries a CUDA tensor across and back
    for method, tol in (("Teko", 1e-3), ("MILU", 1e-3), ("Amesos", 1e-8)):
        s = _small_ocean({"Preconditioning": method, "Precision": "Mixed",
                          "FGMRES tolerance": tol,
                          "FGMRES iterations": 300})
        t0 = time.perf_counter()
        x = s.solve(-s.rhs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        true = _true_relres(s, x, -s.rhs)
        print(f"variant method {method} (masked 8x8x4): MV {s.solve_iters} "
              f"true relres {true:.3e} (tol {tol:g}) in {wall:.3f} s, x on "
              f"{x.device} [{card_line}]", flush=True)
        if not (x.is_cuda and bool(torch.isfinite(x).all()) and true <= tol):
            raise AssertionError(f"method {method}: true relres {true:.3e} "
                                 f"against tol {tol:g}")


def _pencil_residual(o, lam, v) -> float:
    """||J v - lam B v|| / (||J v|| + |lam| ||B v||) in f64 on the model's
    device, for the model's current Jacobian."""
    shape = tuple(o.state.shape)
    Jv = torch.complex(o.apply_matrix(v.real.reshape(shape)),
                       o.apply_matrix(v.imag.reshape(shape)))
    Bv = torch.complex(o.apply_mass_matrix(v.real.reshape(shape)),
                       o.apply_mass_matrix(v.imag.reshape(shape)))
    return float(torch.linalg.norm(Jv - lam * Bv)
                 / (torch.linalg.norm(Jv) + abs(lam) * torch.linalg.norm(Bv)))


def _eigen_small(hopper, card_line: str) -> None:
    """run_ocean on a bundle of the 4x4x3 basin of the eigensolver's own
    tests, with a jdqz_params.xml and eigenvalue analysis at every
    converged point (one continuation step from the trivial solution).
    At this size the solves reach what they are asked, so the pairs
    converge: each is held to the solver's own limit on the true pencil
    residual and to the dense generalized eigenvalues of the same pencil,
    and F and An must come out of the analysis unchanged to the bit."""
    import scipy.linalg
    import scipy.sparse as sp
    from iemic_tpu_torch.config import ParameterList, write_xml
    from iemic_tpu_torch.main import run_ocean
    from iemic_tpu_torch.ops.stencil import stencil_to_csr, to_flat

    with tempfile.TemporaryDirectory() as tmp:
        write_xml(ParameterList("Ocean", {"THCM": {
            "Global Grid-Size n": 4, "Global Grid-Size m": 4,
            "Global Grid-Size l": 3,
            "Starting Parameters": {"Combined Forcing": 0.0,
                                    "Temperature Forcing": 10.0,
                                    "Wind Forcing": 1.0}}}),
            os.path.join(tmp, "ocean_params.xml"))
        write_xml(ParameterList("Continuation parameters", {
            "continuation parameter": "Combined Forcing",
            "initial step size": 0.05, "destination 0": 1.0,
            "maximum number of steps": 1, "Newton tolerance": 1e-6,
            "eigenvalue analysis": "P"}),
            os.path.join(tmp, "continuation_params.xml"))
        write_xml(ParameterList("Solver parameters", {
            "Preconditioning": "BGS", "Precision": "Mixed",
            "FGMRES tolerance": 1e-6, "FGMRES iterations": VARIANT_CAP}),
            os.path.join(tmp, "solver_params.xml"))
        write_xml(ParameterList("JDQZ parameters", dict(JDQZ_PARAMS)),
                  os.path.join(tmp, "jdqz_params.xml"))
        hopper.reset_launches()
        t0 = time.perf_counter()
        status, s, continuation = run_ocean.run(tmp, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = open(os.path.join(tmp, "info_0.txt")).read()
    jdqz = continuation.eigen_solver
    launches = hopper.LAUNCHES
    entry = hopper.kernel_variant(torch.float32, *s.state.shape[1:])
    solves = re.findall(r"FGMRES solve: (\d+) iters, relres=(\S+)",
                        info[info.index("JDQZ: solve"):])
    ptol = max(100.0 * jdqz.tol, 1e-8)
    print(f"eigen run_ocean (4x4x3, eigenvalue analysis P) status {status}: "
          f"{jdqz.kmax_converged} of {jdqz.kmax} pairs converged (tolerance "
          f"{jdqz.tol:g}) in {jdqz.op_applications} solves of the analysis, "
          f"{sum(int(mv) for mv, _ in solves)} MV; run {wall:.1f} s, "
          f"{launches} kernel launches {dict(hopper.LAUNCHES_BY_ENTRY)}; MV "
          "per solve " + " ".join(mv for mv, _ in solves) + " | relres "
          + " ".join(r for _, r in solves) + f" [{card_line}]", flush=True)
    if status != 0 or jdqz.kmax_converged == 0:
        raise AssertionError(f"eigen: status {status}, "
                             f"{jdqz.kmax_converged} pairs converged")
    if launches <= 0 or hopper.LAUNCHES_BY_ENTRY[entry] != launches:
        raise AssertionError(f"eigen: the solves did not go through {entry}: "
                             f"{hopper.LAUNCHES_BY_ENTRY}")
    F0, An0 = s.rhs.clone(), s.jac.clone()
    data, indices, indptr = stencil_to_csr(s.jac, periodic=s.cfg.periodic)
    dense = scipy.linalg.eig(
        sp.csr_matrix((data, indices, indptr)).toarray(),
        np.diag(to_flat(s.diagB).cpu().numpy()), right=False)
    dense = dense[np.isfinite(dense)]
    for lam, v in zip(jdqz.eigenvalues, jdqz.eigenvectors):
        pr = _pencil_residual(s, lam, v)
        off = float(np.abs(dense - lam).min())
        print(f"eigen lambda = {lam.real:.8e} {lam.imag:+.8e}i pencil "
              f"residual {pr:.3e} (limit {ptol:g}), {off:.3e} from the "
              f"nearest dense eigenvalue (limit {1e-4 * max(1.0, abs(lam)):g})",
              flush=True)
        if not (pr < ptol and off < 1e-4 * max(1.0, abs(lam))):
            raise AssertionError(f"eigen pair {lam}: pencil residual "
                                 f"{pr:.3e}, {off:.3e} from the dense set")
    # the analysis left the Jacobian of the converged point: computing F
    # and An again from that state gives the same bits
    s.compute_rhs()
    s.compute_jacobian()
    if not (torch.equal(s.rhs, F0) and torch.equal(s.jac, An0)):
        raise AssertionError("eigen: F or An changed by the analysis")
    print("eigen F and An unchanged to the bit", flush=True)


def _eigen_global(hopper, card_line: str) -> None:
    """JDQZ at 96x38x12 as run_ocean sets it up: a bundle of the effort
    phase's model with a jdqz_params.xml (JDQZ_PARAMS) and eigenvalue
    analysis "P", the analysis run on the bundle's starting point.  Every
    Arnoldi step is a Mixed Ocean.solve through the kernel, held to
    VARIANT_CAP inner iterations with no GMRES-IR tail (_capped_solve):
    the BGS-preconditioned stack does not reach 1e-3 for the right-hand
    sides B v of the Arnoldi vectors, and a solve left to itself goes on
    for hours.  With such solves no pair need converge; the phase says
    whether one did after the first search space and after the restart,
    prints the leading Ritz values with their true pencil residuals, holds
    every pair the solver accepted to the solver's own limit, and checks
    that F and An are unchanged to the bit."""
    from iemic_tpu_torch.config import ParameterList, write_xml
    from iemic_tpu_torch.main import run_ocean

    with tempfile.TemporaryDirectory() as tmp:
        write_xml(ParameterList("Ocean", {
            "THCM": dict(GLOBAL_THCM),
            "Data directory": os.path.join(REPO, "data"),
            "Save state": False}),
            os.path.join(tmp, "ocean_params.xml"))
        write_xml(ParameterList("Continuation parameters", {
            "continuation parameter": "Combined Forcing",
            "initial step size": 0.01, "destination 0": 1.0,
            "eigenvalue analysis": "P"}),
            os.path.join(tmp, "continuation_params.xml"))
        write_xml(ParameterList("Solver parameters", {
            "Preconditioning": "BGS", "Precision": "Mixed",
            "FGMRES tolerance": EFFORT_TOL, "FGMRES iterations": 200}),
            os.path.join(tmp, "solver_params.xml"))
        write_xml(ParameterList("JDQZ parameters", dict(JDQZ_PARAMS)),
                  os.path.join(tmp, "jdqz_params.xml"))
        with run_ocean.bundle(tmp, "cuda") as (o, continuation):
            continuation.initialize()
            o.compute_jacobian()
            F0, An0 = o.rhs.clone(), o.jac.clone()
            o.solve = lambda b: _capped_solve(o, b, VARIANT_CAP)
            hopper.reset_launches()
            t0 = time.perf_counter()
            continuation.run_eigen_solver()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del o.solve
        info = open(os.path.join(tmp, "info_0.txt")).read()
    jdqz = continuation.eigen_solver
    launches = hopper.LAUNCHES
    entry = hopper.kernel_variant(torch.float32, *o.state.shape[1:])
    solves = re.findall(r"FGMRES solve: (\d+) iters, relres=(\S+)", info)
    ptol = max(100.0 * jdqz.tol, 1e-8)
    print(f"eigen JDQZ at 96x38x12 (run_ocean's set-up, eigenvalue analysis "
          f"P at the starting point, at most {VARIANT_CAP} inner iterations a "
          f"solve): {jdqz.op_applications} solves, "
          f"{sum(int(mv) for mv, _ in solves)} MV in {wall:.1f} s, {launches} "
          f"kernel launches {dict(hopper.LAUNCHES_BY_ENTRY)}; MV per solve "
          + " ".join(mv for mv, _ in solves) + " | relres "
          + " ".join(r for _, r in solves) + f" [{card_line}]", flush=True)
    cycles = re.findall(r"JDQZ: (\d+) steps, search space (\d+): (\d+) of "
                        r"\d+ converged; (.*)", info)
    for k, (steps, space, nconv, ritz) in enumerate(cycles):
        bound = "the first bound" if k == 0 else "the bound widened once"
        said = f"{nconv} of {jdqz.kmax} pairs converged" if int(nconv) \
            else "no pair converged"
        print(f"eigen 96x38x12 after {steps} steps ({bound}, search space "
              f"{space}): {said}; {ritz}", flush=True)
    if len(solves) != jdqz.op_applications or not cycles \
            or int(cycles[-1][2]) != jdqz.kmax_converged:
        raise AssertionError("eigen: the run's log does not hold the whole "
                             f"analysis: {len(solves)} solves, {cycles}")
    if launches <= 0 or hopper.LAUNCHES_BY_ENTRY[entry] != launches:
        raise AssertionError(f"eigen: the solves did not go through {entry}: "
                             f"{hopper.LAUNCHES_BY_ENTRY}")
    for lam, v, rel in zip(jdqz.eigenvalues, jdqz.eigenvectors,
                           jdqz.ritz_residuals):
        accepted = rel < jdqz.tol
        pr = _pencil_residual(o, lam, v)
        print(f"eigen 96x38x12 Ritz value {lam.real:.8e} {lam.imag:+.8e}i: "
              f"Ritz residual {rel:.3e} (tolerance {jdqz.tol:g}: "
              f"{'accepted' if accepted else 'not converged'}), pencil "
              f"residual {pr:.3e} (limit {ptol:g} for an accepted pair)",
              flush=True)
        if not (np.isfinite(lam) and np.isfinite(pr)
                and bool(torch.isfinite(torch.view_as_real(v)).all())):
            raise AssertionError(f"eigen: Ritz pair {lam} is not finite")
        if accepted and not pr < ptol:
            raise AssertionError(f"eigen pair {lam}: accepted with pencil "
                                 f"residual {pr:.3e}")
    o.compute_rhs()
    o.compute_jacobian()
    if not (torch.equal(o.rhs, F0) and torch.equal(o.jac, An0)):
        raise AssertionError("eigen: F or An changed by the analysis")
    print("eigen 96x38x12 F and An unchanged to the bit", flush=True)


def phase_eigen(hopper, o, card_line: str) -> None:
    """JDQZ through run_ocean: on a small basin, where the pairs converge
    and are held to the dense spectrum; at 96x38x12 under a bound on every
    solve; and on the effort phase's model o a solve with the shifted
    pencil J - sigma B, which must use factors and a prepared f32 operator
    of the shifted matrix and leave An as it was."""
    from iemic_tpu_torch.models.ocean.ocean import _proj

    _eigen_small(hopper, card_line)
    _eigen_global(hopper, card_line)

    # the shifted pencil at full size
    _set_solver(o, {})
    sigma, b = 0.1, -o.rhs
    o.compute_jacobian()
    o.compute_mass_matrix()
    An0 = o.jac.clone()
    o.solve(b)                       # factors of the unshifted matrix
    o.add_mass_to_jacobian(-sigma)
    before = hopper.LAUNCHES
    x = _capped_solve(o, b, VARIANT_CAP)
    launches = hopper.LAUNCHES - before
    # the residual of the shifted, row-scaled, deflated system, from the
    # unshifted tensor kept above
    nullq, R = o._get_deflator(), o._rowscale
    r = _proj((R * (o._apply(An0, x) - sigma * o.diagB * x - b)).reshape(-1),
              nullq)
    true = float(torch.linalg.norm(r)
                 / torch.linalg.norm(_proj((R * b).reshape(-1), nullq)))
    print(f"eigen shifted solve (J - {sigma:g} B) x = -F at 96x38x12: MV "
          f"{o.solve_iters}, the solve reports {o.solve_relres:.3e}, the "
          f"residual with the shifted pencil is {true:.3e}, {launches} "
          f"kernel launches [{card_line}]", flush=True)
    o.compute_jacobian()
    if not (true < 1.0 and launches > 0
            and true <= RELRES_MARGIN * o.solve_relres + 1e-14
            and torch.equal(o.jac, An0)):
        raise AssertionError("eigen: the shifted solve did not use the "
                             "shifted matrix, or An was not restored")


def _bundle_copy(tmp: str) -> str:
    """Copy run/ocean/global into tmp and cut it to a bounded first
    continuation step: absolute data path, no checkpoint files.

    What is cut, and why.  At the Newton iterates of the bundle's first
    step the BGS-preconditioned solves stop short of the bundle's 1e-4:
    the Mixed stack's f32 inner solve stalls at a relative residual
    between 7e-4 and 2e-2, and the Double stack does no better there
    (3.6e-2 after 400 iterations, PERF.md).  A request below where the
    solve stalls hands the rest to GMRES-IR, whose 300-iteration inner
    solves cost about 20 s each on the card, for up to 120 outer
    iterations, and Newton with such solves does not reach the bundle's
    1e-4 in its 10 iterations.  So the copy asks FGMRES tolerance
    SOLVE_TOL, above where the solves stall, so that every solve is one
    f32 inner solve run to its end, and runs NEWTON_ITERS Newton
    iterations of one step, keeping the unconverged point.  The effort
    phase holds a solve to 1e-3 where the repo records that the stack
    reaches it."""
    from iemic_tpu_torch.config import read_xml, write_xml
    work = os.path.join(tmp, "global")
    shutil.copytree(BUNDLE, work)
    op = read_xml(os.path.join(work, "ocean_params.xml"))
    op.set("Data directory", os.path.join(REPO, "data"))
    op.set("Save state", False)
    write_xml(op, os.path.join(work, "ocean_params.xml"))
    cp = read_xml(os.path.join(work, "continuation_params.xml"))
    cp.set("maximum number of steps", 1)
    cp.set("maximum Newton iterations", NEWTON_ITERS)
    cp.set("reject failed iteration", False)
    write_xml(cp, os.path.join(work, "continuation_params.xml"))
    sp = read_xml(os.path.join(work, "solver_params.xml"))
    sp.set("FGMRES tolerance", SOLVE_TOL)
    write_xml(sp, os.path.join(work, "solver_params.xml"))
    return work


def phase_main(hopper, card_line: str, entry: str = MAIN_ENTRY) -> dict:
    """run_ocean on the cut bundle.  entry is the kernel the run must go
    through: the wrapper's own choice, or the general-shape f32 kernel,
    which the wrapper is then made to take (see --general-kernel)."""
    from iemic_tpu_torch.main import run_ocean

    choose = hopper.kernel_variant
    if entry != MAIN_ENTRY:
        hopper.kernel_variant = \
            lambda *shape: choose(*shape).removesuffix("_wide")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            work = _bundle_copy(tmp)
            hopper.reset_launches()
            t0 = time.perf_counter()
            status = run_ocean.main([work, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = hopper.LAUNCHES
            by_entry = dict(hopper.LAUNCHES_BY_ENTRY)
            info = open(os.path.join(work, "info_0.txt")).read()
            cdata = open(os.path.join(work, "cdata.txt")).read()
            profile = open(os.path.join(work, "profile_output")).read()
    finally:
        hopper.kernel_variant = choose

    print(f"main status={status} wall={wall:.1f} s "
          f"kernel launches={launches} {by_entry}", flush=True)
    for line in cdata.strip().splitlines():
        print("main cdata " + line, flush=True)
    solves = [(int(a), float(b)) for a, b in re.findall(
        r"FGMRES solve: (\d+) iters, relres=(\S+)", info)]
    print("main MV per solve " + " ".join(str(s[0]) for s in solves)
          + " | true relres " + " ".join(f"{s[1]:.2e}" for s in solves),
          flush=True)
    pred = [float(v) for v in re.findall(r"predictor: .*\|rhs\|=(\S+)",
                                         info)]
    newton = [float(v) for v in re.findall(r"Newton iter \d+: \|R\|=(\S+)",
                                           info)]
    print("main |F| predictor " + " ".join(f"{v:.3e}" for v in pred)
          + " | after each Newton iteration "
          + " ".join(f"{v:.3e}" for v in newton), flush=True)
    prof = {}
    for line in profile.splitlines()[1:]:
        parts = line.rsplit(None, 3)
        if len(parts) == 4:
            prof[parts[0].strip()] = (float(parts[1]), float(parts[2]))
    nits = prof.get("Continuation: Newton iterations...", (0, 0))[0]
    newton_s = prof.get("Continuation: Newton", (0.0, 0))[0]
    for key in ("Ocean: compute rhs", "Ocean: compute jacobian",
                "Ocean: build preconditioner", "Ocean: solve",
                "Continuation: Newton"):
        if key in prof:
            print(f"main timer {key}: {prof[key][0]:.3f} s over "
                  f"{int(prof[key][1])} calls [{card_line}]", flush=True)
    if nits:
        print(f"main wall per Newton iteration {newton_s / nits:.3f} s "
              f"({int(nits)} iterations) [{card_line}]", flush=True)

    if status != 0:
        raise AssertionError(f"run_ocean returned {status}")
    if by_entry[entry] <= 0 or by_entry[entry] != launches:
        raise AssertionError(f"the main path did not go through "
                             f"{entry} alone: {by_entry}")
    if not solves or not all(np.isfinite(r) and r < SOLVE_TOL
                             for _, r in solves):
        raise AssertionError("a solve missed its tolerance "
                             f"{SOLVE_TOL:g} or stalled: {solves}")
    if not pred or not newton or not newton[-1] < pred[0]:
        raise AssertionError("|F| did not fall across the Newton "
                             f"iterations: {pred} -> {newton}")
    rows = [ln.split() for ln in cdata.splitlines()
            if ln.strip() and not ln.startswith("#")]
    if len(rows) != 1 or not all(np.isfinite(float(v)) for v in rows[0]):
        raise AssertionError(f"expected one finite cdata row: {rows}")
    return by_entry


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--general-kernel", action="store_true",
        help="after the main phase, run it once more through the "
        "general-shape f32 kernel: the two kernels sum in another order, "
        "so the two MV sequences show what the sequence owes to that")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    card_line = card()
    print(f"device {card_line}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    from iemic_tpu_torch.ops import stencil_hopper as hopper
    t0 = time.perf_counter()
    lib = hopper.build(verbose=True)
    print(f"build {os.path.relpath(lib, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rec = phase_kernel(hopper, card_line)
    t0 = time.perf_counter()
    phase_assembly()
    print(f"assembly phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    model = phase_effort(hopper, card_line)
    print(f"effort phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_variants(hopper, model, card_line)
    print(f"variants phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_eigen(hopper, model, card_line)
    print(f"eigen phase {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    t0 = time.perf_counter()
    launches = phase_main(hopper, card_line)
    print(f"main phase {time.perf_counter() - t0:.1f} s", flush=True)
    if args.general_kernel:
        print("main phase once more, through stencil_matvec_f32:",
              flush=True)
        phase_main(hopper, card_line, "stencil_matvec_f32")

    print(json.dumps({"kernels": [dict(
        name=entry, route="cuda",
        source="iemic_tpu_torch/csrc/stencil_matvec.cu",
        replaces="iemic_tpu/ops/stencil_pallas.py:84",
        launches=launches[entry], **rec[entry])
        for entry in hopper.ENTRIES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
