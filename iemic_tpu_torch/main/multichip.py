"""multichip — the forward step and the domain-decomposed dry run.

Port of the root ``__graft_entry__.py``:

  * :func:`entry` returns the forward step of the flagship model (the
    THCM ocean core: residual, Jacobian, Jacobian action) on a 16x16x8
    ocean, with example arguments.
  * :func:`dryrun_multichip` spawns n ranks (one process each, over
    ``torch.distributed``) that run one Newton step of the ocean over the
    (py, px) rank grid — the analog of the reference's 2D MPI domain
    decomposition (reference src/trios/TRIOS_Domain.H:29-99) — in three
    stages: (1) the partitioned residual and Jacobian and a Double
    BGS-preconditioned solve at 1e-2 (120 iterations); (2) a sharded Mixed
    solve at 2e-2 (refinement sweeps of at most 12 inner iterations, the
    light sweep of the JAX dry run), which raises if it misses its
    tolerance; (3) one pseudo-arclength continuation step (Euler
    predictor, bordered Newton corrector, detect, step control) of a
    ``ShardedOcean``: the JAX dry run's periodic (4 px) x (4 py) x 4 box
    with Columns/Double at 1e-2, or with ``--grid`` the same step of the
    masked global model from rest at Combined Forcing 0 (where rest is
    steady) on the BGS/Double solve at 5e-2.

Usage: python -m iemic_tpu_torch.main.multichip --ranks N
           [--device cuda|cpu] [--backend gloo|nccl] [--grid n m l]

The default device is cuda (each rank on ``cuda:{rank % device_count}``);
asking for cuda without a card raises.  The backend is the caller's
choice, gloo by default: NCCL takes one rank per card and refuses two
ranks on one card, gloo takes any number (CUDA tensors crossing through
the host).  ``--grid 96 38 12`` runs the masked global grid at the design
point (``data/mkmask/mask_global_96x38x12``) from rest; without it the
grid is the JAX dry run's periodic (4 px) x (4 py) x 3 box from a small
random state.

:func:`run_ranks` is the spawning underneath: every rank runs a list of
jobs (functions of this module, by name) and the parent gets each rank's
results.  The rank's function lives in this module, which imports neither
JAX nor any test, so the spawned processes import neither.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA = os.path.join(_REPO, "data")

# the dry run's stages (the JAX dry run's): stage 1's Double solve, stage
# 2's Mixed solve, its light per-block sweep budget and inner tolerance
STAGE1_TOL, STAGE1_ITERS = 1e-2, 120
STAGE2_TOL, STAGE2_ITERS = 2e-2, 12
STAGE2_APPLY = {"nit_spp": 10, "nit_uv": 6}
STAGE2_INNER_TOL = 1e-2
# stage 3 (the JAX dry run's, __graft_entry__.py:240-287): one
# continuation step with a sharded state, its solver and its parameters;
# with a masked global grid the BGS/Double solve at the main phase's
# FGMRES tolerance of chip_smoke.py.  The box's Columns solves stall in
# the corrector (relres 0.4-1.0 after 100 iterations, as in the JAX
# package, tests/test_torch_faults.py); the JAX corrector accepts their
# updates and ends the step, the port's refuses them (ROADMAP A1) and
# would halve the step twenty times.  So the step keeps its unconverged
# corrector, as the JAX one does: it takes the predictor, three bordered
# Newton iterations, detection, step control and the cdata line.
STAGE3_SOLVER = {"Preconditioning": "Columns", "Precision": "Double",
                 "FGMRES tolerance": 1e-2, "FGMRES iterations": 100}
STAGE3_GLOBAL_SOLVER = {"Preconditioning": "BGS", "Precision": "Double",
                        "FGMRES tolerance": 5e-2, "FGMRES iterations": 100}
STAGE3_CONT = {"continuation parameter": "Combined Forcing",
               "initial step size": 0.05, "destination 0": 1.0,
               "maximum number of steps": 1, "Newton tolerance": 1e-2,
               "maximum Newton iterations": 3,
               "reject failed iteration": False}
# repetitions of a halo exchange and a sharded matvec when timing them
TIMED_REPS = 10


def entry(device="cuda"):
    """(forward, (x, par)): one residual + Jacobian + Jacobian-action
    evaluation (the hot path of every Newton-Krylov iteration) of a
    16x16x8 ocean, at a random state (numpy seed 0, as the JAX entry)."""
    from ..models.ocean import Ocean

    thcm = {
        "Global Grid-Size n": 16,
        "Global Grid-Size m": 16,
        "Global Grid-Size l": 8,
        "Periodic": False,
        "Coriolis Force": 1,
        "Starting Parameters": {
            "Combined Forcing": 0.5,
            "Temperature Forcing": 10.0,
            "Wind Forcing": 1.0,
            "Salinity Forcing": 0.1,
        },
    }
    ocean = Ocean({"THCM": thcm}, device=device)

    def forward(x, par):
        F = ocean._rhs(x, par)
        An = ocean._jacobian(x, par)
        return F, ocean._apply(An, F)

    rng = np.random.default_rng(0)
    x = ocean._tensor(0.01 * rng.standard_normal(tuple(ocean.state.shape)))
    return forward, (x, ocean.par)


def global_thcm(n: int, m: int, l: int) -> dict:
    """The masked global ocean of the repo's mask of that size at the
    design point's parameters (the effort configuration)."""
    return {
        "Global Grid-Size n": n, "Global Grid-Size m": m,
        "Global Grid-Size l": l,
        "Global Bound xmin": 0.0, "Global Bound xmax": 360.0,
        "Global Bound ymin": -85.5, "Global Bound ymax": 85.5,
        "Periodic": True, "Read Land Mask": True,
        "Land Mask": f"mask_global_{n}x{m}x{l}",
        "Starting Parameters": {"Combined Forcing": 0.1,
                                "Temperature Forcing": 10.0,
                                "Wind Forcing": 1.0,
                                "Salinity Forcing": 0.1}}


def dryrun_shape(n_ranks: int) -> tuple[int, int]:
    """The JAX dry run's rank grid: py the largest divisor of n_ranks
    not above its square root."""
    py = int(np.sqrt(n_ranks))
    while n_ranks % py:
        py -= 1
    return py, n_ranks // py


def dryrun_config(grid, shape) -> tuple[dict, np.ndarray | None]:
    """(THCM parameters, starting state or None for rest) of the dry run
    on the rank grid shape: the masked global ocean from rest where the
    repo has a mask of the grid's size, else a periodic box from a small
    random state (numpy seed 0); without grid the JAX dry run's
    (4 px) x (4 py) x 3 box."""
    py, px = shape
    n, m, l = grid if grid is not None else (4 * px, 4 * py, 3)
    if os.path.exists(os.path.join(DATA, "mkmask",
                                   f"mask_global_{n}x{m}x{l}")):
        return global_thcm(n, m, l), None
    thcm = {"Global Grid-Size n": n, "Global Grid-Size m": m,
            "Global Grid-Size l": l, "Periodic": True,
            "Starting Parameters": {"Combined Forcing": 0.2,
                                    "Temperature Forcing": 10.0,
                                    "Wind Forcing": 1.0}}
    rng = np.random.default_rng(0)
    return thcm, 0.001 * rng.standard_normal((6, l, m, n))


def stage3_config(grid, shape) -> tuple[dict, dict]:
    """(THCM parameters, solver parameters) of stage 3 on the rank grid
    shape, from rest: the JAX dry run's periodic (4 px) x (4 py) x 4 box
    on Columns/Double; where the repo has a mask of grid's size, that
    grid's masked global ocean on the BGS/Double solve at Combined
    Forcing 0, the start of run/ocean/global's branch.  Rest is the
    steady state there (every forcing term scales with Combined Forcing),
    and not at the dry run's 0.1, where a continuation step would start
    off its branch."""
    py, px = shape
    if grid is not None:
        thcm, _ = dryrun_config(grid, shape)
        if thcm.get("Read Land Mask"):
            start = dict(thcm["Starting Parameters"],
                         **{"Combined Forcing": 0.0})
            return dict(thcm, **{"Starting Parameters": start}), \
                dict(STAGE3_GLOBAL_SOLVER)
    return {"Global Grid-Size n": 4 * px, "Global Grid-Size m": 4 * py,
            "Global Grid-Size l": 4, "Periodic": True, "Coriolis Force": 0,
            "Starting Parameters": {"Combined Forcing": 0.0,
                                    "Temperature Forcing": 10.0,
                                    "Salinity Forcing": 0.1}}, \
        dict(STAGE3_SOLVER)


# ---------------------------------------------------------------------------
# jobs: what a rank runs (every rank of the group together)
# ---------------------------------------------------------------------------

def _ocean(device, thcm: dict, landm=None, state=None, solver=None):
    from ..models.ocean import Ocean
    ocean = Ocean({"THCM": thcm}, solver_params=solver, data_dir=DATA,
                  device=device)
    if landm is not None:
        ocean.set_land_mask(np.asarray(landm), finalized=True)
    if state is not None:
        ocean.set_state(ocean._tensor(state))
    return ocean


def _domain(device, grid, shape, periodic, group=None):
    from ..parallel import Domain
    n, m, l = grid
    return Domain(n, m, l, periodic=periodic, shape=shape, device=device,
                  group=group)


def _ocean_domain(device, thcm: dict, shape, group=None):
    """The Domain of the ocean that thcm describes, on the rank grid
    shape."""
    return _domain(device, [thcm[f"Global Grid-Size {k}"] for k in "nml"],
                   shape, bool(thcm["Periodic"]), group)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device, reps: int = TIMED_REPS) -> float:
    """Host seconds of one call, over reps calls that end synchronised
    (every rank calls together)."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def job_halo(device, x, shape, periodic, depth=1):
    """This rank's block of x padded by halo_pad_shard to depth, with its
    place."""
    from ..parallel import halo_pad_shard
    dom = _domain(device, x.shape[-1:-4:-1], shape, periodic)
    xp = halo_pad_shard(dom.shard_state(torch.as_tensor(x)), dom, depth)
    return {"ry": dom.ry, "rx": dom.rx, "padded": xp.cpu().numpy()}


def job_stencil(device, An, x, shape, periodic):
    """The sharded stencil product, gathered."""
    from ..parallel import make_sharded_stencil_apply
    dom = _domain(device, x.shape[-1:-4:-1], shape, periodic)
    y = make_sharded_stencil_apply(dom)(
        dom.shard_stencil(torch.as_tensor(An)),
        dom.shard_state(torch.as_tensor(x)))
    return dom.gather(y).cpu().numpy()


def job_ops(device, thcm, shape, x=None, v=None, timed=False):
    """make_sharded_ops on the ocean of thcm (at state x, rest without
    it): F and J v gathered (v = -F without v), the gap of J v to the
    serial product Ocean._apply on the gathered J, relative to its max
    norm; with timed, the seconds of a halo exchange and its bytes sent by
    this rank, and the seconds of a sharded matvec."""
    from ..parallel import halo_pad_shard, make_sharded_ops
    dom = _ocean_domain(device, thcm, shape)
    ocean = _ocean(dom.device, thcm)
    ops = make_sharded_ops(ocean, dom)
    x = ocean.state if x is None else ocean._tensor(x)
    x_l = dom.shard_state(x)
    F_l = ops["rhs"](x_l, ocean.par)
    An_l = ops["jac"](x_l, ocean.par)
    v_l = -F_l if v is None else dom.shard_state(ocean._tensor(v))
    y_l = ops["matvec"](An_l, v_l)
    y = dom.gather(y_l)
    ref = ocean._apply(ocean._jacobian(x, ocean.par), dom.gather(v_l))
    out = {"ry": dom.ry, "rx": dom.rx, "F": dom.gather(F_l).cpu().numpy(),
           "Jv": y.cpu().numpy(),
           "gap": float((y - ref).abs().max() / ref.abs().max())}
    if timed:
        sent = dom.sent_bytes
        out["halo_s"] = _seconds(lambda: halo_pad_shard(v_l, dom), dom.device)
        out["halo_bytes"] = (dom.sent_bytes - sent) // (TIMED_REPS + 1)
        out["matvec_s"] = _seconds(lambda: ops["matvec"](An_l, v_l),
                                   dom.device)
    return out


def job_solve(device, thcm, shape, x, tol, maxiter, landm=None,
              precision="Double", apply_opts=None):
    """A sharded solve of J z = -F at the state x (F and J computed on the
    whole ocean, as the JAX tests do), with the domain's gather refusing
    inside it: the gathered z, MV, relres, outer iterations, seconds and
    the BGS preconditioner's stats."""
    from ..parallel import make_sharded_solve
    dom = _ocean_domain(device, thcm, shape)
    ocean = _ocean(dom.device, thcm, landm, state=x)
    ocean.compute_rhs()
    ocean.compute_jacobian()
    An_l, b_l = dom.shard_stencil(ocean.jac), dom.shard_state(-ocean.rhs)
    dom.gather = _refuse_gather
    solve = make_sharded_solve(ocean, dom, precision=precision,
                               apply_opts=apply_opts)
    t0 = time.perf_counter()
    res = solve(An_l, b_l, tol, maxiter)
    _sync(dom.device)
    seconds = time.perf_counter() - t0
    del dom.gather
    return {"z": dom.gather(res.x).cpu().numpy(), "mv": res.mv,
            "relres": res.relres, "outer": res.outer, "seconds": seconds,
            "bgs": _bgs_stats(solve)}


def job_model_solve(device, thcm, shape, solver, x, landm=None,
                    group=None):
    """ShardedOcean.solve of J z = -F at the state x, on the ocean of thcm
    and the solver parameters solver, with the domain's gather refusing
    in the solve, and its gather to one rank too unless the method is a
    host one (Amesos, MILU): the gathered z, MV, relres, seconds, Mixed
    refinement sweeps and tail iterations, and the gathers of the solve,
    the stats of the solve's preconditioner, and of its BGS
    preconditioner (None for another method)."""
    from ..parallel import ShardedOcean
    from ..solvers.factory import HOST_METHODS
    dom = _ocean_domain(device, thcm, shape, group)
    model = ShardedOcean(_ocean(dom.device, thcm, landm, state=x,
                                solver=solver), dom)
    model.compute_rhs()
    model.compute_jacobian()
    gathers = dom.gathers
    dom.gather = _refuse_gather
    if model._method not in HOST_METHODS:
        dom.gather_to = _refuse_gather
    t0 = time.perf_counter()
    z = model.solve(-model.rhs)
    _sync(dom.device)
    seconds = time.perf_counter() - t0
    gathers = dom.gathers - gathers
    del dom.gather
    dom.__dict__.pop("gather_to", None)
    return {"z": dom.gather(z).cpu().numpy(), "mv": model.solve_iters,
            "relres": model.solve_relres, "seconds": seconds,
            "sweeps": model.solve_sweeps, "outer": model.solve_outer,
            "gathers": gathers,
            "prec": model._solve.preconditioner().stats(),
            "bgs": _bgs_stats(model._solve)}


def job_prec(device, thcm, shape, An, r, method, params=None, group=None):
    """The sharded solve's preconditioner of method
    (``parallel.methods``) built on this rank's block of the whole
    stencil tensor An (whose integral row is taken unscaled) and applied
    to its block of r, with the domain's gather refusing, and its gather
    to one rank too unless the method is a host one: the gathered z and
    the preconditioner's stats."""
    from ..parallel.methods import make_preconditioner
    from ..solvers.factory import HOST_METHODS
    dom = _ocean_domain(device, thcm, shape, group)
    ocean = _ocean(dom.device, thcm)
    An_l = dom.shard_stencil(torch.as_tensor(An, device=dom.device))
    r_l = dom.shard_state(torch.as_tensor(r, device=dom.device))
    dom.gather = _refuse_gather
    if method not in HOST_METHODS:
        dom.gather_to = _refuse_gather
    prec = make_preconditioner(ocean, dom, method, params)(An_l, 1.0)
    z = prec(r_l)
    del dom.gather
    dom.__dict__.pop("gather_to", None)
    return {"z": dom.gather(z).cpu().numpy(), "stats": prec.stats()}


def job_newton(device, thcm, shape, x, tol, maxiter, landm=None):
    """One Newton step through make_sharded_ops (sharded residual and
    Jacobian, Double solve) from the state x: the gathered new state."""
    from ..parallel import make_sharded_ops
    dom = _ocean_domain(device, thcm, shape)
    ocean = _ocean(dom.device, thcm, landm)
    ops = make_sharded_ops(ocean, dom)
    x_l = dom.shard_state(ocean._tensor(x))
    F = ops["rhs"](x_l, ocean.par)
    res = ops["solve"](ops["jac"](x_l, ocean.par), -F, tol, maxiter)
    return dom.gather(x_l + res.x).cpu().numpy()


def _refuse_gather(*args, **kw):
    raise AssertionError("a partitioned path gathered")


def _bgs_stats(solve) -> dict | None:
    """The stats of a sharded solve's last BGS preconditioner (None for
    another method and before the first solve)."""
    from ..parallel.bgs import PartitionedBGS
    prec = solve.preconditioner()
    return prec.stats() if isinstance(prec, PartitionedBGS) else None


def job_assembly(device, thcm, shape, x, landm=None, gathered=True,
                 timed=False, group=None):
    """make_sharded_ops' partitioned rhs and jac at the state x, with the
    domain's gather refusing inside them: the gaps of the gathered F and
    An to the serial Ocean._rhs and Ocean._jacobian, relative to their
    largest entries, and with gathered the gathered F and An (on rank 0
    of the group); with timed
    the seconds of rhs and of jac and the seconds and bytes sent of one
    2-deep halo exchange."""
    from ..parallel import halo_extend, make_sharded_ops
    dom = _ocean_domain(device, thcm, shape, group)
    ocean = _ocean(dom.device, thcm, landm)
    ops = make_sharded_ops(ocean, dom)
    x = ocean._tensor(x)
    x_l = dom.shard_state(x)
    dom.gather = _refuse_gather
    F_l = ops["rhs"](x_l, ocean.par)
    An_l = ops["jac"](x_l, ocean.par)
    out = {"ry": dom.ry, "rx": dom.rx}
    if timed:
        out["rhs_s"] = _seconds(lambda: ops["rhs"](x_l, ocean.par),
                                dom.device, 3)
        out["jac_s"] = _seconds(lambda: ops["jac"](x_l, ocean.par),
                                dom.device, 3)
        sent = dom.sent_bytes
        out["halo2_s"] = _seconds(lambda: halo_extend(x_l, dom, 2),
                                  dom.device)
        out["halo2_bytes"] = (dom.sent_bytes - sent) // (TIMED_REPS + 1)
    del dom.gather
    F, An = dom.gather(F_l), dom.gather(An_l)
    Fs, As = ocean._rhs(x, ocean.par), ocean._jacobian(x, ocean.par)
    out["F_gap"] = float((F - Fs).abs().max() / Fs.abs().max())
    out["An_gap"] = float((An - As).abs().max() / As.abs().max())
    if gathered and dom.rank == 0:
        out["F"], out["An"] = F.cpu().numpy(), An.cpu().numpy()
    return out


def job_bgs(device, thcm, shape, An=None, r=None, landm=None,
            cases=({},), builds=None, f32=True):
    """The partitioned BGS preconditioner (``parallel.bgs``) built and
    applied on this rank's block of the rank grid shape, on the ocean of
    thcm and landm (its integral-condition row), with the domain's gather
    refusing in the builds and sweeps.  An and r are the whole stencil
    tensor and vector; without them this rank's block of the Jacobian at
    the ocean's state (the partitioned assembly) and r = -F.  For each
    apply_opts of cases, with the build_opts of builds beside it (the
    sharded solve's build without builds), the gathered sweep of r and
    the preconditioner's stats; with f32, also the f32 sweep of the first
    case's factors cast as the Mixed solve casts them.  On the card, the
    peak of the device memory this rank allocated from the first build
    on."""
    from ..parallel import make_sharded_ops
    from ..parallel.bgs import PartitionedBGS, int_row_of
    dom = _ocean_domain(device, thcm, shape)
    ocean = _ocean(dom.device, thcm, landm)
    if An is None:
        ops = make_sharded_ops(ocean, dom)
        x_l = dom.shard_state(ocean.state)
        An_l = ops["jac"](x_l, ocean.par)
        r_l = -ops["rhs"](x_l, ocean.par)
    else:
        An_l = dom.shard_stencil(torch.as_tensor(An, device=dom.device))
        r_l = dom.shard_state(torch.as_tensor(r, device=dom.device))
    int_row = int_row_of(ocean, float(ocean.cfg.int_sign))
    cuda = dom.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dom.device)
    dom.gather = _refuse_gather
    sweeps = []
    for k, (opts, bopts) in enumerate(zip(cases,
                                          builds or [None] * len(cases))):
        prec = PartitionedBGS(An_l, ocean.landm, dom, int_row=int_row,
                              apply_opts=opts, build_opts=bopts,
                              held=(An_l,))
        z = prec(r_l)
        z32 = None
        if f32 and k == 0:
            z32 = PartitionedBGS(An_l, ocean.landm, dom, int_row=int_row,
                                 dtype=torch.float32, apply_opts=opts,
                                 build_opts=bopts)(r_l.to(torch.float32))
        sweeps.append((z, z32, prec.stats()))
        del prec
    del dom.gather
    return {"ry": dom.ry, "rx": dom.rx,
            "peak": torch.cuda.max_memory_allocated(dom.device) if cuda
            else None,
            "sweeps": [{"z": dom.gather(z).cpu().numpy(),
                        "z32": None if z32 is None
                        else dom.gather(z32).cpu().numpy(),
                        "stats": st} for z, z32, st in sweeps]}


def job_columns(device, thcm, shape, x, v, group=None):
    """The column-block preconditioner built and applied on this rank's
    block of the Jacobian at x (no gather), on the block of v: the
    gathered result."""
    from ..parallel import make_sharded_ops
    from ..solvers.preconditioner import (apply_column_prec,
                                          build_column_blocks)
    dom = _ocean_domain(device, thcm, shape, group)
    ocean = _ocean(dom.device, thcm)
    ops = make_sharded_ops(ocean, dom)
    An_l = ops["jac"](dom.shard_state(ocean._tensor(x)), ocean.par)
    dom.gather = _refuse_gather
    z_l = apply_column_prec(build_column_blocks(An_l),
                            dom.shard_state(ocean._tensor(v)))
    del dom.gather
    return dom.gather(z_l).cpu().numpy()


def spinup(ocean, comb: float, iters: int = 10) -> None:
    """Newton on the serial ocean onto Combined Forcing comb (the JAX
    package's tests/test_parallel.py:275-287)."""
    ocean.set_par("Combined Forcing", comb)
    for _ in range(iters):
        ocean.compute_rhs()
        if float(torch.linalg.norm(ocean.rhs)) < 1e-11:
            break
        ocean.compute_jacobian()
        ocean.set_state(ocean.get_state() + ocean.solve(-ocean.rhs))


def sharded_continuation(dom, thcm, solver, cont, x=None, comb=None,
                         cdata=None) -> dict:
    """Continuation(cont) of a ShardedOcean over dom: the ocean of thcm
    and solver from the state x (rest without it), spun up serially to
    Combined Forcing comb where given; cdata names this rank's cdata
    file.  Returns the result's status, steps and par, the gathered
    state, the Newton iterations, every solve's (MV, relres, seconds),
    the seconds of the run, of each residual and of each Jacobian, and
    the stats of the last BGS preconditioner (None for Columns)."""
    from ..continuation import Continuation
    from ..parallel import ShardedOcean
    from ..utils import logging as log
    ocean = _ocean(dom.device, thcm, state=x, solver=solver)
    if comb is not None:
        spinup(ocean, comb)
    model = ShardedOcean(ocean, dom)
    rhs_s, jac_s = [], []

    def timed(fn, into):
        def call(*args):
            _sync(dom.device)
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(dom.device)
            into.append(time.perf_counter() - t0)
            return out
        return call

    solve, secs = model.solve, []
    model.solve = timed(solve, secs)
    model.compute_rhs = timed(model.compute_rhs, rhs_s)
    model.compute_jacobian = timed(model.compute_jacobian, jac_s)
    log.set_cdata_file(cdata)
    cont_ = Continuation(model, cont)
    t0 = time.perf_counter()
    res = cont_.run()
    seconds = time.perf_counter() - t0
    log.set_cdata_file(None)
    solves = [(mv, rr, s) for (mv, rr), s in zip(model.solve_log, secs)]
    return {"status": res.status, "steps": res.steps,
            "newton": res.sum_newton_iters,
            "par": model.get_par(cont["continuation parameter"]),
            "state": model.gather_state().cpu().numpy(),
            "solves": solves, "seconds": seconds, "rhs_s": rhs_s,
            "jac_s": jac_s, "bgs": _bgs_stats(model._solve)}


def job_continuation(device, thcm, shape, solver, cont, x=None, comb=None,
                     workdir=None, group=None):
    """sharded_continuation on the rank grid shape; with workdir each
    rank names its own cdata file there, and the result says whether
    this rank's file exists."""
    dom = _ocean_domain(device, thcm, shape, group)
    cdata = None if workdir is None else \
        os.path.join(workdir, f"cdata_{dist.get_rank()}.txt")
    out = sharded_continuation(dom, thcm, solver, cont, x=x, comb=comb,
                               cdata=cdata)
    out.update(rank=dom.rank, ry=dom.ry, rx=dom.rx)
    if cdata is not None:
        out["cdata"] = open(cdata).read() if os.path.exists(cdata) \
            else None
    return out


def job_gate(device, workdir):
    """Each rank writes a checkpoint and a cdata line to its own files
    through the port's writers; returns which of its files exist."""
    from ..utils import hdf5, logging as log
    rank = dist.get_rank()
    h5 = os.path.join(workdir, f"state_{rank}.h5")
    cdata = os.path.join(workdir, f"cdata_{rank}.txt")
    hdf5.save_state(h5, np.zeros(4), {"Combined Forcing": 0.0})
    log.set_cdata_file(cdata)
    log.write_cdata("0 1 2")
    log.set_cdata_file(None)
    dist.barrier()
    return {"h5": os.path.exists(h5), "cdata": os.path.exists(cdata)}


def job_launches(device):
    """This process's launches of the Hopper stencil kernel, by entry
    point (the sharded path launches none, as the JAX package's reaches
    no Pallas kernel)."""
    from ..ops import stencil_hopper
    return dict(stencil_hopper.LAUNCHES_BY_ENTRY)


def job_modules(device):
    """The modules of JAX and of the JAX package this process imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "iemic_tpu"))


def job_dryrun(device, grid=None):
    """The dry run's three stages on the group's ranks; rank 0 prints a
    line per stage.  Returns this rank's numbers, among them the stats of
    stage 1's and stage 2's BGS preconditioners, and on rank 0 the
    gathered Newton update of stage 1 and the state after stage 3's
    step (``step``: sharded_continuation's result)."""
    from ..parallel import halo_pad_shard, make_sharded_ops
    from ..parallel.halo import make_sharded_solve
    t_start = time.perf_counter()
    size = dist.get_world_size() if dist.is_initialized() else 1
    shape = dryrun_shape(size)
    thcm, x0 = dryrun_config(grid, shape)
    n, m, l = (thcm[f"Global Grid-Size {k}"] for k in "nml")
    dom = _domain(device, (n, m, l), shape, True)
    ocean = _ocean(dom.device, thcm)
    ops = make_sharded_ops(ocean, dom)
    x = dom.shard_state(ocean.state if x0 is None else ocean._tensor(x0))

    # ---- stage 1: sharded residual and Jacobian, Double BGS solve ------
    _sync(dom.device)
    t0 = time.perf_counter()
    F = ops["rhs"](x, ocean.par)
    An = ops["jac"](x, ocean.par)
    _sync(dom.device)
    rhs_jac_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ops["solve"](An, -F, STAGE1_TOL, STAGE1_ITERS)
    _sync(dom.device)
    solve_s = time.perf_counter() - t0
    true = dom.norm(F + ops["matvec"](An, res.x)) / dom.norm(F)
    stage1_s = time.perf_counter() - t_start
    sent = dom.sent_bytes
    halo_s = _seconds(lambda: halo_pad_shard(F, dom), dom.device)
    halo_bytes = (dom.sent_bytes - sent) // (TIMED_REPS + 1)
    matvec_s = _seconds(lambda: ops["matvec"](An, F), dom.device)
    update = dom.gather(res.x)
    if dom.rank == 0:
        print(f"dryrun_multichip: Newton step OK on {size} ranks (grid of "
              f"ranks {dom.py}x{dom.px}, grid {n}x{m}x{l}, "
              f"{dom.backend or 'no process group'}, {dom.device}), "
              f"BGS-FGMRES {res.mv} iters, relres={res.relres:.1e}, true "
              f"relres={true:.1e} [{stage1_s:.1f} s]", flush=True)

    # ---- stage 2: sharded Mixed solve at the same state ----------------
    ocean.set_state(dom.gather(x))
    ocean.compute_rhs()
    ocean.compute_jacobian()
    solve_mixed = make_sharded_solve(ocean, dom, precision="Mixed",
                                     apply_opts=STAGE2_APPLY,
                                     inner_tol=STAGE2_INNER_TOL)
    t0 = time.perf_counter()
    res2 = solve_mixed(dom.shard_stencil(ocean.jac),
                       dom.shard_state(-ocean.rhs), STAGE2_TOL, STAGE2_ITERS)
    _sync(dom.device)
    mixed_s = time.perf_counter() - t0
    # the Mixed solve's relres is its explicit f64 residual: a true one
    if not res2.relres <= STAGE2_TOL:
        raise RuntimeError(
            f"dryrun_multichip: Mixed sharded solve MISSED its tolerance "
            f"on rank {dom.rank}: relres={res2.relres:.1e} > "
            f"{STAGE2_TOL:.0e}")
    if dom.rank == 0:
        print(f"dryrun_multichip: Mixed sharded solve OK, {res2.mv} inner "
              f"iters ({res2.outer} outer), relres={res2.relres:.1e} <= "
              f"{STAGE2_TOL:.0e} [{time.perf_counter() - t_start:.1f} s "
              "total]", flush=True)

    # ---- stage 3: one continuation step with a sharded state -----------
    thcm3, solver3 = stage3_config(grid, shape)
    dom3 = _ocean_domain(device, thcm3, shape)
    step = sharded_continuation(dom3, thcm3, solver3, STAGE3_CONT)
    if step["status"] != 0 or step["steps"] != 1:
        raise RuntimeError(f"dryrun_multichip: the sharded continuation "
                           f"step failed on rank {dom.rank}: status "
                           f"{step['status']}, {step['steps']} steps")
    grid3 = "x".join(str(thcm3[f"Global Grid-Size {k}"]) for k in "nml")
    if dom.rank == 0:
        print(f"dryrun_multichip: sharded continuation step OK "
              f"(status={step['status']}, par={step['par']:.3f}) on grid "
              f"{grid3}, {step['newton']} Newton iterations, "
              f"{solver3['Preconditioning']}/{solver3['Precision']} solves "
              f"{[mv for mv, _, _ in step['solves']]} MV "
              f"[{time.perf_counter() - t_start:.1f} s total]", flush=True)
    return {"rank": dom.rank, "ry": dom.ry, "rx": dom.rx, "grid": (n, m, l),
            "shape": shape, "backend": dom.backend,
            "device": str(dom.device), "mv": res.mv, "relres": res.relres,
            "true_relres": true, "rhs_jac_s": rhs_jac_s, "solve_s": solve_s,
            "halo_s": halo_s,
            "halo_bytes": halo_bytes, "matvec_s": matvec_s,
            "mixed_mv": res2.mv, "mixed_outer": res2.outer,
            "mixed_relres": res2.relres, "mixed_s": mixed_s,
            "bgs": _bgs_stats(ops["solve"]),
            "mixed_bgs": _bgs_stats(solve_mixed),
            "update": update.cpu().numpy() if dom.rank == 0 else None,
            "step": dict(step, state=step["state"] if dom.rank == 0
                         else None)}


JOBS = {"halo": job_halo, "stencil": job_stencil, "ops": job_ops,
        "solve": job_solve, "model_solve": job_model_solve,
        "prec": job_prec,
        "newton": job_newton, "gate": job_gate,
        "bgs": job_bgs,
        "assembly": job_assembly, "columns": job_columns,
        "continuation": job_continuation,
        "launches": job_launches, "modules": job_modules,
        "dryrun": job_dryrun}


def _rank_main(rank, n_ranks, init_method, backend, device, jobs, workdir,
               timeout_s):
    """One rank: join the group, run the jobs, write the results."""
    from ..parallel.multihost import initialize_environment
    from ..utils import logging as log
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log.set_verbose(False)
    initialize_environment(backend, init_method, n_ranks, rank, timeout_s)
    results = []
    for name, kw in jobs:
        kw = dict(kw)
        k = kw.pop("ranks", None)
        if k is None:
            results.append(JOBS[name](device, **kw))
            continue
        # a job on the first k ranks: every rank makes the group
        group = dist.new_group(list(range(k)))
        results.append(JOBS[name](device, group=group, **kw)
                       if rank < k else None)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_ranks(n_ranks: int, jobs, *, device="cuda", backend: str = "gloo",
              timeout_s: float = 600.0) -> list[list]:
    """Spawn n_ranks processes joined over backend, each running every
    (name, keywords) job of jobs in order on device; returns
    results[rank][job].  A job whose keywords hold ``ranks=k`` runs on a
    group of the first k ranks (the others' result is None).  A rank that raises ends the run: the others are
    stopped and this raises (torch.multiprocessing.spawn with join)."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: device cuda but no CUDA device "
                           "(pass device=\"cpu\" to run on the CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, nprocs=n_ranks, join=True, args=(
            n_ranks, f"file://{tmp}/store", backend, str(device), list(jobs),
            tmp, timeout_s))
        results = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def dryrun_multichip(n_ranks: int, device="cuda", grid=None,
                     backend: str | None = None) -> list[dict]:
    """The three-stage dry run on n_ranks spawned ranks (see the module
    note); backend None is gloo.  Prints the stages and one line per rank;
    returns each rank's numbers.  Raises where a rank fails or stage 2
    misses its tolerance."""
    backend = backend or "gloo"
    print(f"dryrun_multichip: {n_ranks} ranks over {backend} on {device}, "
          f"grid {grid or 'of the JAX dry run'}", flush=True)
    out = run_ranks(n_ranks, [("dryrun", {"grid": grid}), ("launches", {})],
                    device=device, backend=backend)
    ranks = [dict(dryrun, launches=launches) for dryrun, launches in out]
    print_ranks(ranks)
    return ranks


def print_ranks(ranks: list[dict], tag: str = "dryrun_multichip") -> None:
    """One line per rank of the dry run's numbers, and one per BGS
    preconditioner of its stages."""
    from ..parallel.bgs import format_stats
    for r in ranks:
        print(f"{tag} rank {r['rank']} ({r['ry']},{r['rx']}) {r['device']}: "
              f"halo exchange {r['halo_s'] * 1e3:.3f} ms, "
              f"{r['halo_bytes']} bytes sent; sharded matvec "
              f"{r['matvec_s'] * 1e3:.3f} ms; residual and Jacobian "
              f"{r['rhs_jac_s']:.3f} s; Double solve {r['mv']} MV, "
              f"true relres {r['true_relres']:.3e}, {r['solve_s']:.3f} s; "
              f"Mixed solve {r['mixed_mv']} MV, {r['mixed_outer']} outer, "
              f"relres {r['mixed_relres']:.3e}, {r['mixed_s']:.3f} s",
              flush=True)
        for stage, key in (("1", "bgs"), ("2", "mixed_bgs")):
            print(f"{tag} rank {r['rank']} stage {stage} "
                  f"{format_stats(r[key])}", flush=True)
        if r["step"]["bgs"] is not None:
            print(f"{tag} rank {r['rank']} stage 3 "
                  f"{format_stats(r['step']['bgs'])}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multichip")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--grid", type=int, nargs=3, default=None,
                    metavar=("N", "M", "L"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device,
                     grid=tuple(args.grid) if args.grid else None,
                     backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
