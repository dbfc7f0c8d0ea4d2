"""Explicit halo exchange, the sharded stencil matvec and the sharded
solve, over torch.distributed.

Port of ``iemic_tpu/parallel/halo.py``.  The reference surrounds every
RHS/Jacobian evaluation with Standard->Assembly / Assembly->Solve ghost
imports (2-deep overlap, reference src/trios/TRIOS_Domain.H:273-290, used
at src/ocean/THCM.C:972,999).  The matrix-free stencil matvec needs a
1-deep halo, the assembly a 2-deep one, exchanged between the ranks'
neighbours with ``dist.batch_isend_irecv``:

  * y (latitude): walls — ranks at the global edge receive zeros,
    matching the reference's zero Dirichlet padding.
  * x (longitude): optional periodic wraparound — the last rank
    neighbours the first (reference TRIOS_Domain.H:337-340); with one
    rank in x the block wraps onto itself with no traffic.
  * corner (diagonal) ghosts come for free from the two-stage exchange:
    y first, then x over the already-y-padded block.
  * z is never partitioned; k ghosts are zero-padded locally
    (reference TRIOS_Domain.H:63-84).

The matvec contracts the 27 windows of the padded block in plain PyTorch,
as the JAX package contracts them in an einsum under ``shard_map``: the
Hopper stencil kernel pads its input itself and cannot take neighbour
halos, and the JAX package's sharded path reaches no Pallas kernel.

Torch has no GSPMD.  Where the JAX package jits the residual and the
Jacobian with sharded inputs and lets XLA partition them, every rank here
evaluates the serial assembly on its block extended by a 2-deep halo
(:mod:`.assembly`, ``halo_extend`` at depth 2).  The column-block
preconditioner is local to each rank, since z is never partitioned; the
block-GS factors are built and the sweep applied on each rank's block
(:mod:`.bgs`), with no gather of the stencil tensor.  The Krylov solve is
distributed the same way: each rank holds its block of every Krylov
vector, the matvec exchanges halos, and every inner product and norm is a
sum over ranks (``Domain.allreduce``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.ocean.ocean import MIXED_SWEEPS
from ..ops.stencil import OCEAN, SS, TT
from ..solvers.fgmres import fgmres_flat, fgmres_host

F32 = torch.float32


class ShardedSolve(NamedTuple):
    """A sharded solve's result.  ``mv`` is the effort in the unit of
    ``Ocean.solve``: FGMRES iterations for Double; for Mixed the f32
    inner iterations of the refinement sweeps plus those of the GMRES-IR
    tail.  ``outer`` counts the tail's f64 iterations apart (0 without a
    tail)."""
    x: torch.Tensor       # this rank's block of the solution
    mv: int
    relres: float         # of the (row-scaled, deflated) system solved
    outer: int


def _swap(domain, first: torch.Tensor, last: torch.Tensor, down, up):
    """One axis of the exchange: send ``last`` to the rank ``up`` (where it
    is the low ghost) and ``first`` to the rank ``down`` (the high ghost);
    returns (lo, hi) received from down and up, zeros at a wall."""
    comm = torch.device("cpu") if domain.staged else first.device
    lo = torch.zeros(first.shape, dtype=first.dtype, device=comm)
    hi = torch.zeros(last.shape, dtype=last.dtype, device=comm)
    # one order on every rank, sends then receives, low face first: NCCL
    # matches the messages between two ranks in that order, gloo by tag
    ops = []
    if up is not None:
        out = last.to(comm).contiguous()
        ops.append(dist.P2POp(dist.isend, out, up, domain.group, tag=0))
        domain.sent_bytes += out.numel() * out.element_size()
    if down is not None:
        out = first.to(comm).contiguous()
        ops.append(dist.P2POp(dist.isend, out, down, domain.group, tag=1))
        domain.sent_bytes += out.numel() * out.element_size()
    if down is not None:
        ops.append(dist.P2POp(dist.irecv, lo, down, domain.group, tag=0))
    if up is not None:
        ops.append(dist.P2POp(dist.irecv, hi, up, domain.group, tag=1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return lo.to(first.device), hi.to(first.device)


def halo_extend(xl: torch.Tensor, domain, depth: int = 1) -> torch.Tensor:
    """Extend a local (..., ml, nl) block to (..., ml+2d, nl+2d) with the
    neighbours' halos of depth d: the y stage sends the d edge rows, the x
    stage the d edge columns of the y-extended block, so the corners come
    along.  Zeros at a wall; with one rank in x on a periodic grid the
    block wraps onto itself.  Every rank of the domain calls it
    together."""
    ml, nl = xl.shape[-2:]
    if ml < depth or nl < depth:
        raise ValueError(
            f"halo of depth {depth} around a block of {ml}x{nl} cells: "
            f"each neighbour sends its {depth} edge rows and columns, so "
            f"the blocks must be at least {depth} wide")
    # ---- y (j / latitude) ghosts: global walls get zeros -------------
    lo, hi = _swap(domain, xl[..., :depth, :], xl[..., -depth:, :],
                   domain.south, domain.north)
    xj = torch.cat([lo, xl, hi], dim=-2)

    # ---- x (i / longitude) ghosts, including corners ------------------
    if domain.px == 1 and domain.periodic:
        lo, hi = xj[..., -depth:], xj[..., :depth]
    else:
        lo, hi = _swap(domain, xj[..., :depth], xj[..., -depth:],
                       domain.west, domain.east)
    return torch.cat([lo, xj, hi], dim=-1)


def halo_pad_shard(xl: torch.Tensor, domain, depth: int = 1) -> torch.Tensor:
    """Pad a local (nun, l, ml, nl) block to (nun, l+2d, ml+2d, nl+2d)
    with the neighbours' halos of depth d (:func:`halo_extend`) and zero
    surface/bottom ghosts.  Every rank of the domain calls it together."""
    # ---- z ghosts: surface/bottom, always zero -------------------------
    return torch.nn.functional.pad(halo_extend(xl, domain, depth),
                                   (0, 0, 0, 0, depth, depth))


def make_sharded_stencil_apply(domain):
    """(An_l, x_l) -> this rank's block of An x.

    The analog of the reference's Epetra CSR SpMV with ghost import
    (matetc.F90:147-166 + TRIOS importers): each rank exchanges 1-deep
    halos and contracts its 27 local windows (``ops.stencil.
    apply_stencil``'s product, on the padded block), the partitioned
    sweep's product (``.bgs.PartitionedGrid.st``)."""
    from .bgs import PartitionedGrid
    return PartitionedGrid(domain).st


def _check_device(ocean, domain) -> None:
    if ocean.state.device != domain.device:
        raise ValueError(f"the ocean lives on {ocean.state.device}, this "
                         f"rank's domain on {domain.device}")


def _make_matvec(ocean, domain):
    """(An_l, v_l, scale) -> this rank's block of the Jacobian action with
    the salinity integral-condition row (THCM.C:2121-2196) times scale:
    the integral is a sum over ranks, which every rank joins; the rank
    that owns the row's cell writes it."""
    cfg = ocean.cfg
    apply_st = make_sharded_stencil_apply(domain)
    int_coeff = domain.shard_state(ocean.int_coeff)
    _, k, j, i = ocean.rowintcon
    own = domain.owns(j, i)
    ir = (SS, k, j - domain.j0, i - domain.i0)

    def matvec(An_l, v_l, scale=1.0):
        y = apply_st(An_l, v_l)
        if cfg.sres == 0:
            intval = domain.allreduce(torch.sum(int_coeff.to(v_l.dtype)
                                                * v_l)[None])[0]
            if own:
                y[ir] = scale * cfg.int_sign * intval
        return y

    return matvec


def make_sharded_ops(ocean, domain):
    """Sharded hot-path operators for an Ocean model living on this rank's
    device.  Returns a dict with:

      * ``matvec(An_l, v_l)`` — Jacobian action (halo-exchange stencil +
        the salinity-integral-condition row, THCM.C:2121-2196); the
        integral dot is a global reduction.
      * ``rhs(x_l, par, int_correction=0.0)`` / ``jac(x_l, par)`` — this
        rank's block of the residual and of the stencil tensor, evaluated
        on the block extended by a 2-deep halo
        (:mod:`.assembly`); neither gathers.
      * ``solve(An_l, b_l, tol, maxiter)`` — the Double sharded solve
        (:func:`make_sharded_solve`).
    """
    from .assembly import make_partitioned_assembly
    _check_device(ocean, domain)
    rhs, jac = make_partitioned_assembly(ocean, domain)
    return {"matvec": _make_matvec(ocean, domain), "rhs": rhs, "jac": jac,
            "solve": make_sharded_solve(ocean, domain)}


def sharded_deflator(ocean, domain, An_l: torch.Tensor):
    """This rank's rows (n_l, k) of the orthonormal basis of the pressure
    null modes of the Jacobian whose block is An_l, the modes
    ``Ocean._get_deflator`` keeps (a candidate whose product with J is
    below 1e-10 of J's largest entry), or None.  The products and the
    largest entry are taken over the ranks; the candidates and their
    orthonormalisation are the mask's, on the host."""
    from ..solvers.preconditioner import pressure_null_vectors
    cfg = ocean.cfg
    matvec = _make_matvec(ocean, domain)
    cands = pressure_null_vectors(ocean.landm, cfg.l, cfg.m, cfg.n,
                                  periodic=cfg.periodic)
    scale = domain.amax(torch.abs(An_l))
    valid = []
    for z in cands:
        z_l = domain.shard_state(torch.as_tensor(z, dtype=An_l.dtype))
        rz = domain.amax(torch.abs(matvec(An_l, z_l)))
        if rz < 1e-10 * max(scale, 1.0):
            valid.append(z.reshape(-1))
    if not valid:
        return None
    q, _ = np.linalg.qr(np.stack(valid, axis=1))
    q = torch.as_tensor(q.T.reshape(-1, 6, cfg.l, cfg.m, cfg.n),
                        dtype=An_l.dtype)
    return domain.shard_state(q).reshape(q.shape[0], -1).T.contiguous()


def _row_scale(ocean, domain, An_l):
    """``scaling.row_col_scaling``'s row field R on this rank's block of
    the Jacobian, and its value at the integral-condition row: the
    averaged centre block is a sum over the ranks."""
    from ..models.ocean import scaling
    cfg = ocean.cfg
    ml, nl = domain.local_shape
    ocean_g = ocean.landm[1:cfg.l + 1, 1:cfg.m + 1, 1:cfg.n + 1] == OCEAN
    ocean_l = ocean_g[:, domain.j0:domain.j0 + ml, domain.i0:domain.i0 + nl]
    mask = torch.as_tensor(ocean_l, dtype=An_l.dtype, device=An_l.device)
    db = domain.allreduce((An_l[4] * mask).sum(dim=(2, 3, 4))) \
        / max(int(ocean_g.sum()), 1)
    dr, _ = scaling.scal(db.cpu().numpy())
    R = np.where(ocean_l[None], (1.0 / dr)[:, None, None, None], 1.0)
    R[TT] = R[SS] = 0.5 * (R[TT] + R[SS])
    _, k, j, i = ocean.rowintcon
    rint = 0.5 * (1.0 / dr[TT] + 1.0 / dr[SS]) if ocean_g[k, j, i] else 1.0
    return torch.as_tensor(R, dtype=An_l.dtype, device=An_l.device), rint


def check_method(preconditioner: str, precision: str) -> None:
    """Raise ValueError, naming it, for a method or combination of the
    solver parameters that the sharded solve does not run: it runs BGS
    (Double or Mixed) and Columns (Double)."""
    if preconditioner not in ("BGS", "Columns"):
        raise ValueError(f"the sharded solve does not run Preconditioning "
                         f"{preconditioner!r}: it runs BGS and Columns")
    if preconditioner == "Columns" and precision == "Mixed":
        raise ValueError("the sharded solve does not run Preconditioning "
                         "'Columns' with Precision 'Mixed': the sharded "
                         "Columns solve takes Precision Double")


def make_sharded_solve(ocean, domain, *, precision: str = "Double",
                       preconditioner: str = "BGS",
                       apply_opts: dict | None = None,
                       build_opts: dict | None = None,
                       scale_double: bool = False,
                       inner_tol: float = 1e-4, stall_limit: int = 8,
                       tail_iters: int = 60, nullq="ocean"):
    """Sharded BGS-preconditioned FGMRES solve (the full solve path of
    §3.1 over the ranks): the Krylov matvec exchanges halos, the block-GS
    preconditioner is factored and applied on each rank's block
    (:class:`.bgs.PartitionedBGS`; no gather), and the pressure null modes
    are deflated globally: ``Q^T v`` is a sum over the ranks of their
    rows.  nullq is this rank's rows of the modes' basis
    (:func:`sharded_deflator`) or None; "ocean" takes the modes of the
    ocean's Jacobian where it has one, as the JAX package does.

    preconditioner="Columns" is the column-block preconditioner
    (``solvers.preconditioner``), local to each rank since z is never
    partitioned.  Its solve is ``Ocean._solve_operator``'s with Columns
    and Double: THCM row scaling where the ocean asks for it (the averaged
    centre block a sum over the ranks) and the deflation above; Double
    only.  Any other method, and Columns with Mixed, raise ValueError
    naming it (:func:`check_method`).

    Returns ``solve(An_l, b_l, tol, maxiter) -> ShardedSolve`` — the
    multi-rank equivalent of Ocean.solve, for the np in {1, 2, 4, 8}
    equivalence regression (reference src/tests/CMakeLists.txt:77-87).
    The BGS solve keeps its factors while the solves take the same
    tensor, as Ocean keeps its own; ``solve.preconditioner()`` is the
    PartitionedBGS of the last tensor (None before the first solve).

    The BGS factors are ``bgs.build``'s with build_opts over the JAX
    package's sharded solve's build (MG on ATS); apply_opts are the
    sweep's keywords (``bgs.apply``'s).  precision="Double" is the all-f64
    path, on the THCM-row-scaled system where scale_double and the ocean
    ask for it (as ``Ocean.solve`` solves it; the dry run's Double solve
    is the JAX package's, unscaled).  "Mixed" solves the THCM-row-scaled
    system with f32 Krylov operators (matvec and sweep) inside f64
    Arnoldi: host-driven f64 iterative-refinement sweeps (at most
    ``Ocean``'s MIXED_SWEEPS, each an inner solve to ``inner_tol`` that
    gives up after ``stall_limit`` stalled iterations), then a GMRES-IR
    tail (an outer f64 FGMRES of at most tail_iters iterations
    preconditioned by inner solves at 1e-2) where the sweeps stop short.  The defaults are the
    dry run's (the JAX package's sharded solve's); ``ShardedOcean`` passes
    ``Ocean.solve``'s.
    """
    from .bgs import PartitionedBGS, check_branches, int_row_of
    _check_device(ocean, domain)
    check_method(preconditioner, precision)
    apply_kw = dict(apply_opts or {})
    cfg = ocean.cfg
    ml, nl = domain.local_shape
    shape = (6, cfg.l, ml, nl)
    matvec = _make_matvec(ocean, domain)

    if isinstance(nullq, str):
        nullq = None
        if ocean.jac is not None and ocean._get_deflator() is not None:
            q = ocean._get_deflator()
            nullq = domain.shard_state(
                q.T.reshape(-1, 6, cfg.l, cfg.m, cfg.n)) \
                .reshape(q.shape[1], -1).T.contiguous()

    def proj(v, Q):
        return v if Q is None else v - Q @ domain.allreduce(Q.T @ v)

    if preconditioner == "Columns":
        return _columns_solve(ocean, domain, matvec, proj, nullq, shape)
    check_branches(apply_kw)
    built = {}

    def factored(An_l, prep):
        """prep(An_l) = (the operator's tensors, the preconditioner),
        kept while the solves take the same tensor."""
        if built.get("An") is not An_l:
            built.clear()
            ops, prec = prep(An_l)
            built.update(An=An_l, ops=ops, prec=prec)
        return built["ops"], built["prec"]

    def scaled(An_l, scale: bool):
        """The block row-scaled where scale and the ocean ask for it, its
        row scale (None unscaled) and the integral row's scale."""
        if not (scale and cfg.scaling == "THCM"):
            return An_l, None, 1.0
        R_l, rint = _row_scale(ocean, domain, An_l)
        return An_l * R_l[None, :, None], R_l, rint

    def preconditioner_of(An_s, rint, dtype=None, held=()):
        return PartitionedBGS(An_s, ocean.landm, domain,
                              int_row=int_row_of(ocean, rint * cfg.int_sign),
                              dtype=dtype, apply_opts=apply_kw,
                              build_opts=build_opts, held=held)

    def prep_double(An_l):
        """The (row-scaled) block, its row scale, the integral row's scale
        and the f64 sweep of the block."""
        An_s, R_l, rint = scaled(An_l, scale_double)
        return (An_s, R_l, rint), preconditioner_of(An_s, rint,
                                                    held=(An_s,))

    def solve_double(An_l, b_l, tol, maxiter):
        (An_s, R_l, rint), sweep = factored(An_l, prep_double)
        if R_l is not None:
            b_l = b_l * R_l

        def mv(v):
            return proj(matvec(An_s, v.reshape(shape), rint).reshape(-1),
                        nullq)

        def pc(v):
            return proj(sweep(v.reshape(shape)).reshape(-1), nullq)

        flat_b = proj(b_l.reshape(-1), nullq)
        res = fgmres_flat(mv, pc, flat_b, torch.zeros_like(flat_b),
                          float(tol), maxiter, reduce=domain.reduce)
        return ShardedSolve(proj(res.x, nullq).reshape(shape), res.iters,
                            res.relres, 0)

    def last():
        return built.get("prec")

    if precision != "Mixed":
        solve_double.preconditioner = last
        return solve_double

    # ---- Mixed: host-driven f64 iterative refinement ------------------
    # The sharded twin of Ocean._solve_mixed_host + _gmres_ir_host: each
    # sweep runs one f32-operator Krylov solve and an exact f64 residual
    # refresh; a sweep that fails to halve the true residual ends
    # refinement (the f32 noise floor), and any remaining distance to the
    # target is closed by GMRES-IR, monotone by construction.  The
    # row-scaled system (R J) z = R b is solved, like the production path
    # (scaling.py THCM row scaling, Ocean.C:1206-1214): the raw Jacobian's
    # rows span many orders, which f32 would lose.
    nullq32 = None if nullq is None else nullq.to(F32)

    def prep_mixed(An_l):
        """The row-scaled block, its f32 copy, the f32 sweep of it, the
        row scale and the integral row's scale."""
        An_s, R_l, rint = scaled(An_l, True)
        An32 = An_s.to(F32)
        return (An_s, An32, R_l, rint), preconditioner_of(
            An_s, rint, dtype=F32, held=(An_s, An32))

    def inner(An32, sweep32, r, tol, rint, maxiter):
        """One f32-operator Krylov solve with f64 Arnoldi of the
        normalized residual r."""
        def mv_h(v):
            y = matvec(An32, v.to(F32).reshape(shape), rint).reshape(-1)
            return proj(y, nullq32).to(r.dtype)

        def pc_h(v):
            z = sweep32(v.to(F32).reshape(shape))
            return proj(z.reshape(-1), nullq32).to(r.dtype)

        # stall_limit: the f32 inner solve meets its inexact-matvec noise
        # floor after O(1) iterations when the sweep is near-exact; bail
        # out and let the refinement sweeps and the tail contract instead
        res = fgmres_flat(mv_h, pc_h, r, torch.zeros_like(r), tol, maxiter,
                          stall_limit=stall_limit, reduce=domain.reduce)
        return proj(res.x, nullq), res.iters

    def solve_mixed(An_l, b_l, tol, maxiter):
        (An_l, An32, R_l, rint), sweep32 = factored(An_l, prep_mixed)

        def mv64(v):
            return proj(matvec(An_l, v.reshape(shape), rint).reshape(-1),
                        nullq)

        if R_l is not None:
            b_l = b_l * R_l
        flat_b = proj(b_l.reshape(-1), nullq)
        bn = domain.norm(flat_b)
        target = float(tol) * (bn if bn > 0 else 1.0)
        x = torch.zeros_like(flat_b)
        r, rn = flat_b, bn
        total = outer = 0
        for _ in range(MIXED_SWEEPS):
            if rn <= target:
                break
            dz, its = inner(An32, sweep32, r / rn, inner_tol, rint, maxiter)
            total += its
            x_new = x + dz * rn
            r_new = flat_b - mv64(x_new)
            rn_new = domain.norm(r_new)
            if rn_new >= 0.5 * rn:
                if rn_new < rn:
                    x, r, rn = x_new, r_new, rn_new
                break
            x, r, rn = x_new, r_new, rn_new
        if rn > target:
            # GMRES-IR tail: outer f64 FGMRES on the correction system
            # preconditioned by a short (1e-2) f32 inner solve
            inner_count = 0

            def pc(v):
                nonlocal inner_count
                vn = domain.norm(v)
                if vn == 0.0:
                    return v
                dz, its = inner(An32, sweep32, v / vn, 1e-2, rint, maxiter)
                inner_count += its
                return dz * vn

            dx, res = fgmres_host(mv64, r, prec=pc, tol=target / rn,
                                  maxiter=tail_iters, reduce=domain.reduce)
            outer = res.iters
            x_new = x + dx
            rn_new = domain.norm(flat_b - mv64(x_new))
            if rn_new < rn:      # monotone: never return a worse iterate
                x, rn = x_new, rn_new
            total += inner_count
        return ShardedSolve(x.reshape(shape), total, rn / max(bn, 1e-300),
                            outer)

    solve_mixed.preconditioner = last
    return solve_mixed


def _columns_solve(ocean, domain, matvec, proj, nullq, shape):
    """The Columns + Double solve of ``Ocean._solve_operator``
    (``_get_prec_factors``, ``_solve_double``) on this rank's block."""
    from ..solvers.preconditioner import (apply_column_prec,
                                          build_column_blocks)
    cfg = ocean.cfg
    built = {}

    def scaled(An_l):
        """The row-scaled block, its row scale, the integral row's scale
        and the column factors, kept while the solves take the same
        tensor (as Ocean keeps its factors)."""
        if built.get("An") is not An_l:
            built.clear()
            R_l, rint, An_s = None, 1.0, An_l
            if cfg.scaling == "THCM":
                R_l, rint = _row_scale(ocean, domain, An_l)
                An_s = An_l * R_l[None, :, None]
            built.update(An=An_l, R=R_l, rint=rint, An_s=An_s,
                         factors=build_column_blocks(An_s))
        return built["An_s"], built["R"], built["rint"], built["factors"]

    def solve(An_l, b_l, tol, maxiter):
        An_l, R_l, rint, factors = scaled(An_l)
        if R_l is not None:
            b_l = b_l * R_l

        def mv(v):
            return proj(matvec(An_l, v.reshape(shape), rint).reshape(-1),
                        nullq)

        def pc(v):
            return proj(apply_column_prec(factors, v.reshape(shape))
                        .reshape(-1), nullq)

        flat_b = proj(b_l.reshape(-1), nullq)
        res = fgmres_flat(mv, pc, flat_b, torch.zeros_like(flat_b),
                          float(tol), maxiter, reduce=domain.reduce)
        return ShardedSolve(proj(res.x, nullq).reshape(shape), res.iters,
                            res.relres, 0)

    return solve
