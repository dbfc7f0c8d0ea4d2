"""Explicit halo exchange, the sharded stencil matvec and the sharded
solve, over torch.distributed.

Port of ``iemic_tpu/parallel/halo.py``.  The reference surrounds every
RHS/Jacobian evaluation with Standard->Assembly / Assembly->Solve ghost
imports (2-deep overlap, reference src/trios/TRIOS_Domain.H:273-290, used
at src/ocean/THCM.C:972,999).  The matrix-free stencil matvec needs a
1-deep halo, exchanged between the ranks' neighbours with
``dist.batch_isend_irecv``:

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

Torch has no GSPMD.  Where the JAX package jits the residual, the
Jacobian and the block-GS factor build and sweep with sharded inputs and
lets XLA partition them, every rank here evaluates them on the gathered
global tensor and keeps its block: replicated work, correct on any
decomposition, and the open item of partitioning them stands in ROADMAP.
What is distributed is the Krylov solve: each rank holds its block of
every Krylov vector, the matvec exchanges halos, and every inner product
and norm is a sum over ranks (``Domain.allreduce``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops.stencil import SS, offsets
from ..solvers import bgs
from ..solvers.fgmres import fgmres_flat, fgmres_host

_OFFS = offsets()
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


def halo_pad_shard(xl: torch.Tensor, domain) -> torch.Tensor:
    """Pad a local (nun, l, ml, nl) block to (nun, l+2, ml+2, nl+2) with
    the neighbours' halos.  Every rank of the domain calls it together."""
    # ---- y (j / latitude) ghosts: global walls get zeros -------------
    lo, hi = _swap(domain, xl[:, :, :1, :], xl[:, :, -1:, :],
                   domain.south, domain.north)
    xj = torch.cat([lo, xl, hi], dim=2)

    # ---- x (i / longitude) ghosts, including corners ------------------
    if domain.px == 1 and domain.periodic:
        lo, hi = xj[:, :, :, -1:], xj[:, :, :, :1]
    else:
        lo, hi = _swap(domain, xj[:, :, :, :1], xj[:, :, :, -1:],
                       domain.west, domain.east)
    xij = torch.cat([lo, xj, hi], dim=3)

    # ---- z ghosts: surface/bottom, always zero -------------------------
    return torch.nn.functional.pad(xij, (0, 0, 0, 0, 1, 1))


def make_sharded_stencil_apply(domain):
    """(An_l, x_l) -> this rank's block of An x.

    The analog of the reference's Epetra CSR SpMV with ghost import
    (matetc.F90:147-166 + TRIOS importers): each rank exchanges 1-deep
    halos and contracts its 27 local windows (``ops.stencil.
    apply_stencil``'s product, on the padded block)."""

    def apply(An_l: torch.Tensor, x_l: torch.Tensor) -> torch.Tensor:
        nun, l, ml, nl = x_l.shape
        xp = halo_pad_shard(x_l, domain)
        windows = torch.stack([
            xp[:, 1 + dk:1 + dk + l, 1 + dj:1 + dj + ml, 1 + di:1 + di + nl]
            for (di, dj, dk) in _OFFS])
        return (An_l * windows.unsqueeze(1)).sum(dim=(0, 2))

    return apply


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
        on the gathered global state with ``Ocean._rhs`` and
        ``Ocean._jacobian`` (replicated work, see the module note).
      * ``solve(An_l, b_l, tol, maxiter)`` — the Double sharded solve
        (:func:`make_sharded_solve`).
    """
    _check_device(ocean, domain)
    cfg = ocean.cfg
    matvec = _make_matvec(ocean, domain)

    def rhs(x_l, par, int_correction=0.0):
        x = domain.gather(x_l)
        F = ocean._rhs(x, par)
        if cfg.sres == 0:
            F[ocean.rowintcon] = cfg.int_sign * (
                torch.sum(ocean.int_coeff * x) - int_correction)
        return domain.shard_state(F)

    def jac(x_l, par):
        return domain.shard_stencil(ocean._jacobian(domain.gather(x_l), par))

    return {"matvec": matvec, "rhs": rhs, "jac": jac,
            "solve": make_sharded_solve(ocean, domain)}


def make_sharded_solve(ocean, domain, *, precision: str = "Double",
                       apply_opts: dict | None = None,
                       inner_tol: float = 1e-4, stall_limit: int = 8):
    """Sharded BGS-preconditioned FGMRES solve (the full solve path of
    §3.1 over the ranks): the Krylov matvec exchanges halos, the block-GS
    preconditioner is factored and applied on the gathered vector on
    every rank, and the pressure null modes (of the ocean's Jacobian when
    it has one, as in the JAX package) are deflated globally:
    ``Q^T v`` is a sum over the ranks of their rows.

    Returns ``solve(An_l, b_l, tol, maxiter) -> ShardedSolve`` — the
    multi-rank equivalent of Ocean.solve, for the np in {1, 2, 4}
    equivalence regression (reference src/tests/CMakeLists.txt:77-87).

    precision="Double" is the all-f64 path.  "Mixed" solves the
    THCM-row-scaled system with f32 Krylov operators (matvec and sweep)
    inside f64 Arnoldi: host-driven f64 iterative-refinement sweeps (at
    most 12, each an inner solve to ``inner_tol`` that gives up after
    ``stall_limit`` stalled iterations), then a GMRES-IR tail (an outer
    f64 FGMRES of at most 60 iterations preconditioned by inner solves at
    1e-2) where the sweeps stop short.  apply_opts are the sweep's
    per-block knobs (``bgs.apply``'s keywords); the multichip dry run
    passes a lighter budget.
    """
    _check_device(ocean, domain)
    apply_kw = dict(apply_opts or {})
    cfg = ocean.cfg
    landm = ocean.landm
    ml, nl = domain.local_shape
    shape = (6, cfg.l, ml, nl)
    matvec = _make_matvec(ocean, domain)

    nullq = None
    if ocean.jac is not None and ocean._get_deflator() is not None:
        q = ocean._get_deflator()
        nullq = domain.shard_state(q.T.reshape(-1, 6, cfg.l, cfg.m, cfg.n)) \
            .reshape(q.shape[1], -1).T.contiguous()

    def proj(v, Q):
        return v if Q is None else v - Q @ domain.allreduce(Q.T @ v)

    def build(An_g, int_scale):
        int_row = ((ocean.int_coeff, ocean.rowintcon, int_scale)
                   if cfg.sres == 0 else None)
        return bgs.build(An_g, landm, periodic=cfg.periodic,
                         ts_precond="MG", int_row=int_row)

    def sweep(factors, graphs, v_l):
        z = bgs.apply(factors, domain.gather(v_l), periodic=cfg.periodic,
                      graphs=graphs, **apply_kw)
        return domain.shard_state(z)

    def graphs_for(factors):
        return bgs.SweepGraphs(factors) if domain.device.type == "cuda" \
            else None

    def solve_double(An_l, b_l, tol, maxiter):
        factors = build(domain.gather(An_l), float(cfg.int_sign))
        graphs = graphs_for(factors)

        def mv(v):
            return proj(matvec(An_l, v.reshape(shape)).reshape(-1), nullq)

        def pc(v):
            return proj(sweep(factors, graphs, v.reshape(shape))
                        .reshape(-1), nullq)

        flat_b = proj(b_l.reshape(-1), nullq)
        res = fgmres_flat(mv, pc, flat_b, torch.zeros_like(flat_b),
                          float(tol), maxiter, reduce=domain.reduce)
        return ShardedSolve(proj(res.x, nullq).reshape(shape), res.iters,
                            res.relres, 0)

    if precision != "Mixed":
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
    from ..models.ocean import scaling
    from ..models.ocean.ocean import _to_dtype
    max_sweeps = 12
    nullq32 = None if nullq is None else nullq.to(F32)

    def prep(An_l):
        An_g = domain.gather(An_l)
        if cfg.scaling == "THCM":
            R, _ = scaling.row_col_scaling(An_g, landm)
            rint = float(R[ocean.rowintcon])
            An_g = An_g * R[None, :, None]
            R_l = domain.shard_state(R)
        else:
            R_l, rint = None, 1.0
        factors32 = _to_dtype(build(An_g, rint * cfg.int_sign), F32)
        An_l = domain.shard_stencil(An_g)
        return An_l, factors32, graphs_for(factors32), An_l.to(F32), R_l, \
            rint

    def inner(An32, factors32, graphs, r, tol, rint, maxiter):
        """One f32-operator Krylov solve with f64 Arnoldi of the
        normalized residual r."""
        def mv_h(v):
            y = matvec(An32, v.to(F32).reshape(shape), rint).reshape(-1)
            return proj(y, nullq32).to(r.dtype)

        def pc_h(v):
            z = sweep(factors32, graphs, v.to(F32).reshape(shape))
            return proj(z.reshape(-1), nullq32).to(r.dtype)

        # stall_limit: the f32 inner solve meets its inexact-matvec noise
        # floor after O(1) iterations when the sweep is near-exact; bail
        # out and let the refinement sweeps and the tail contract instead
        res = fgmres_flat(mv_h, pc_h, r, torch.zeros_like(r), tol, maxiter,
                          stall_limit=stall_limit, reduce=domain.reduce)
        return proj(res.x, nullq), res.iters

    def solve_mixed(An_l, b_l, tol, maxiter):
        An_l, factors32, graphs, An32, R_l, rint = prep(An_l)

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
        for _ in range(max_sweeps):
            if rn <= target:
                break
            dz, its = inner(An32, factors32, graphs, r / rn, inner_tol, rint,
                            maxiter)
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
                dz, its = inner(An32, factors32, graphs, v / vn, 1e-2, rint,
                                maxiter)
                inner_count += its
                return dz * vn

            dx, res = fgmres_host(mv64, r, prec=pc, tol=target / rn,
                                  maxiter=60, reduce=domain.reduce)
            outer = res.iters
            x_new = x + dx
            rn_new = domain.norm(flat_b - mv64(x_new))
            if rn_new < rn:      # monotone: never return a worse iterate
                x, rn = x_new, rn_new
            total += inner_count
        return ShardedSolve(x.reshape(shape), total, rn / max(bn, 1e-300),
                            outer)

    return solve_mixed
