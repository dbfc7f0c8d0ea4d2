"""Physics-based block Gauss-Seidel preconditioner (De Niet & Wubs),
PyTorch.

Port of ``iemic_tpu/solvers/bgs.py`` (the reference's tailored ocean
preconditioner, TRIOS_BlockPreconditioner.H:36-100, sweeps
TRIOS_BlockPreconditioner.C:1479-1917 SolveLower1/2/3 and SolveUpper).
The configuration every shipped bundle uses is permutation M1, plain
Gauss-Seidel, the 3D saddle solved by FGMRES with the SIMPLE ('SI')
preconditioner, and a semicoarsened multigrid on the tracer block ATS.
One M1 sweep:

  1. baroclinic pressure   ytilp = Ap \\ b_w            (column solves)
  2. 3D saddle             [Auv Guv*lift; mean(Duv .) 0] [yuv, pbar]
  3. full pressure         y_p = ytilp + pbar, checkerboard-projected
  4. vertical velocity     y_w = Aw \\ (b_p - Duv y_uv)  (column solves)
  5. tracers               y_TS = ATS \\ (b_TS - BTSuv y_uv - BTSw y_w)

The other branches: saddle schemes 'SL' and 'SR' (SIMPLE(L), SIMPLER),
the legacy scheme 'KRYLOV' (the depth-averaged 2D saddle, preconditioned
by point-block Jacobi or a 2D multigrid, and a separate Auv solve);
orderings M2 and M3, which also take the 2D saddle; the symmetric
backward correction; the rho/mu transform of the tracer block; Columns
or MG on Auv and on ATS.

Every block stays a slice of the stencil tensor; the slices the sweep
applies are cut once in :func:`build`.

:func:`build` and :func:`apply` reach the grid through a grid-operations
object (``grid``; ``mg.Whole``, the whole grid on one device, by
default): the stencil products, sums and norms over the grid, the zonal
line solve, the multigrid's finest level and the whole of a 2D field.
``parallel.bgs`` passes one rank's block of the grid instead, and the
sweep's order of operations stays here, once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.stencil import UU, VV, WW, PP, TT, SS, windows
from ..utils import logging as log
from . import mg as _mg
from .fgmres import fgmres_flat
from .preconditioner import (inv, column_blocks, to_columns, from_columns,
                             apply_col_inv)
from .saddlepoint import build_simple, apply_simple, deflate

_UV = slice(UU, VV + 1)
_TS = slice(TT, SS + 1)
_W = slice(WW, WW + 1)
_P = slice(PP, PP + 1)
_UVP = [UU, VV, PP]


def _column_tridiag_factor(diag, down, up, *, eps=1e-12):
    """Factor per-column block-tridiagonal systems into batched inverses;
    structurally deficient rows (zero diagonal relative to the block's
    scale: land, the top continuity row, the surface hydrostatic row,
    TRIOS_BlockPreconditioner.C:478-487) are gauged to identity and
    their rhs entries must be zeroed on apply.  Returns (binv, dummy)."""
    T = column_blocks(diag, down, up)
    dg = torch.abs(torch.diagonal(T, dim1=1, dim2=2))     # (mn, d)
    blockscale = torch.clamp(torch.amax(torch.abs(T), dim=(1, 2)), min=eps)
    dummy = dg < 1e-6 * blockscale[:, None]
    dummyf = dummy.to(T.dtype)
    T = T * (1.0 - dummyf)[:, :, None] + torch.diag_embed(dummyf)
    return inv(T), dummy


def _apply_tridiag_inv(binv, dummy, b):
    """Apply factored per-column tridiag inverses: b (nv, l, m, n)."""
    nv, l, m, n = b.shape
    bc = to_columns(b).masked_fill(dummy, 0.0)
    x = torch.bmm(binv, bc.unsqueeze(-1)).squeeze(-1)
    return from_columns(x, nv, l, m, n)


def _column_block_inv(sub, *, eps=1e-12):
    """Batched inverses of the vertical column blocks of a sub-block
    (27, nv, nv, l, m, n); all-zero rows gauged to identity."""
    B = column_blocks(sub[4], sub[13], sub[22])
    dummy = (torch.amax(torch.abs(B), dim=2) < eps).to(B.dtype)
    return inv(B + torch.diag_embed(dummy))


def _column_tridiag_solve(diag, down, up, b, *, eps=1e-12):
    """One-shot factor and apply (the sweep uses the prefactored path)."""
    binv, dummy = _column_tridiag_factor(diag, down, up, eps=eps)
    return _apply_tridiag_inv(binv, dummy, b)


def _apply_2d(S, x, periodic):
    """2D 9-point stencil matvec: S (9, nv, nv, m, n), x (nv, m, n); the
    dk = 0 plane of the 27-point operator on a one-layer grid."""
    w = windows(x[:, None], periodic)[:9, :, 0]       # (9, nv, m, n)
    return (S * w.unsqueeze(1)).sum(dim=(0, 2))


class BGSPrec(NamedTuple):
    """Factored state of the block-GS preconditioner.  The depth-averaged
    2D saddle's pieces (Spp, Spp_binv, spp_simple, spp_mg) are of the
    whole grid, the others of the grid's part (see :func:`build`)."""
    A_uvuv: torch.Tensor      # (27, 2, 2, l, m, n) sub-blocks of An
    A_uvp: torch.Tensor       # (27, 2, 1, ...)
    A_puv: torch.Tensor       # (27, 1, 2, ...)
    A_tsts: torch.Tensor      # (27, 2, 2, ...)
    A_tsuv: torch.Tensor      # (27, 2, 2, ...)
    A_tsw: torch.Tensor       # (27, 2, 1, ...)
    A_wts: torch.Tensor       # (27, 1, 2, ...) buoyancy (M2, M3, symmetric)
    Spp: torch.Tensor         # (9, 3, 3, m, n) depth-averaged saddle
    Spp_binv: torch.Tensor    # (m*n, 3, 3) its point-block inverses
    uv_binv: torch.Tensor     # (m*n, 2l, 2l) Auv column-block inverses
    ts_binv: torch.Tensor     # (m*n, 2l, 2l) ATS column-block inverses
    uv_xinv: torch.Tensor     # zonal line inverses of Auv (saddle Ahat)
    uv_xdummy: torch.Tensor
    ap_binv: torch.Tensor     # (m*n, l, l) hydrostatic (w rows, p col)
    ap_dummy: torch.Tensor
    aw_binv: torch.Tensor     # (m*n, l, l) continuity (p rows, w col)
    aw_dummy: torch.Tensor
    svp: torch.Tensor         # (2, l, m, n) pressure null modes
    sv2d: torch.Tensor        # (2, m, n) barotropic null modes
    spp_simple: object        # saddlepoint.SppSimple; its nullmodes are
    #                           sv2d of the whole grid
    ts_null: torch.Tensor     # (2, 2, l, m, n) validated TS null modes
    dir_mask: torch.Tensor    # (6, l, m, n) 1.0 on pure-diagonal rows
    dir_diag: torch.Tensor    # (6, l, m, n) their diagonal values
    # multigrid hierarchies, built when the block's "... Precond" is "MG"
    uv_mg: object = None
    ts_mg: object = None      # on ts_rm when the rho/mu transform is on
    spp_mg: object = None     # on the 2D saddle, as a one-layer tensor
    # rho/mu transform of the TS block (setup_rhomu,
    # TRIOS_BlockPreconditioner.C:1376-1419): Q is a per-point (T, S)
    # involution into (density, spiciness)-like variables
    Qts: torch.Tensor | None = None         # (2, 2), Q^2 = I
    ts_rm: torch.Tensor | None = None       # (27, 2, 2, l, m, n) Q A_TS Q
    ts_rm_binv: torch.Tensor | None = None  # its column-block inverses
    ts_null_rm: torch.Tensor | None = None  # Q ts_null, orthonormalized
    # salinity integral-condition row threaded into the ATS operator
    # (THCM.C:2121-2196): coefficients, (k, j, i), row scale * int_sign
    ts_icoeff: torch.Tensor | None = None
    ts_iidx: tuple | None = None
    ts_iscale: torch.Tensor | None = None


def build(An: torch.Tensor, landm: np.ndarray, *, periodic: bool,
          dzw=None, spp_scheme: str = "SI", rhomu: bool = False,
          rhomu_lambda: float = 7.6e-4 / 1.8e-4,
          uv_precond: str = "Columns", ts_precond: str = "Columns",
          spp_precond: str = "Jacobi", int_row=None,
          spp_prolong_w: float = 0.25, uv_prolong_w: float = 0.25,
          ts_prolong_w: float = 0.25, grid=None) -> BGSPrec:
    """Factor the preconditioner from the (row-scaled) stencil tensor.

    int_row: optional (coeff (6, l, m, n), (var, k, j, i), scale), the
    outer operator's salinity integral-condition row, threaded into the
    ATS inner operator so the subsolve is nonsingular.  landm is the
    padded (l+2, m+2, n+2) land mask; dzw optional (l,) layer weights of
    the depth average (uniform by default).  spp_scheme is accepted for
    the JAX signature: the SIMPLE factors are always built.  Each block's
    multigrid has its own prolongation weight: spp_prolong_w for the 2D
    saddle's (Chat and the saddle MG), uv_prolong_w for Auv's,
    ts_prolong_w for ATS's.  An is grid's part of the tensor (the whole
    of it by default); landm and int_row's coefficients are whole, its
    (k, j, i) a point of the whole grid."""
    g = grid if grid is not None else _mg.Whole(periodic)
    _, nun, _, l, m, n = An.shape
    mw, nw = g.shape(An)          # the whole grid's
    kw = dict(dtype=An.dtype, device=An.device)
    ocean_g = torch.as_tensor(
        (np.asarray(landm)[1:l + 1, 1:mw + 1, 1:nw + 1] == 0), **kw)
    ocean = g.local(ocean_g)
    if int_row is not None:
        coeff, (var, k, j, i), scale = int_row
        icoeff = g.local(torch.as_tensor(coeff, **kw)[_TS]).contiguous()
        iidx = (int(k), int(j), int(i))
        iscale = torch.as_tensor(scale, **kw)
    else:
        icoeff = iidx = iscale = None

    # ---- depth-averaged 2D saddle over (u, v, p), of the whole grid --
    sub = An[:, _UVP][:, :, _UVP]                # (27, 3, 3, l, m, n)
    w = torch.ones((l,), **kw) if dzw is None \
        else torch.as_tensor(np.asarray(dzw, np.float64), **kw)
    Spp = g.whole(torch.einsum('pABkji,k->pABji',
                               sub[:9] + sub[9:18] + sub[18:27],
                               w / w.sum()))

    # point-block Jacobi factors of Spp with a shift on the singular
    # pressure point-block (the p diagonal of the saddle is 0)
    D = Spp[4].permute(2, 3, 0, 1).reshape(mw * nw, 3, 3)
    scale = torch.clamp(torch.amax(torch.abs(D), dim=(1, 2), keepdim=True),
                        min=1e-12)
    ee = torch.zeros(3, **kw)
    ee[2] = 1.0
    D = D + scale * ee[:, None] * ee[None, :]
    dummy = (torch.amax(torch.abs(D), dim=2) < 1e-12).to(D.dtype)
    Spp_binv = inv(D + torch.diag_embed(dummy))

    sub_uv = An[:, _UV, _UV].contiguous()
    sub_ts = An[:, _TS, _TS].contiguous()
    uv_binv = _column_block_inv(sub_uv)
    ts_binv = _column_block_inv(sub_ts)

    # pressure null modes (constant + checkerboard over ocean points,
    # TRIOS_BlockPreconditioner.H:489-494) and their 2D shadows, of the
    # whole mask; the 2D saddle's SIMPLE factors and multigrids, like
    # its operator, are whole
    ij = (np.arange(mw)[:, None] + np.arange(nw)[None, :]) % 2
    cbpat = torch.as_tensor(np.where(ij == 0, 1.0, -1.0), **kw)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v), min=1e-300)

    svp = g.local(torch.stack([unit(ocean_g), unit(ocean_g * cbpat)]))
    wet = torch.amax(ocean_g, dim=0)
    sv2d_g = torch.stack([unit(wet), unit(wet * cbpat)])
    sv2d = g.local(sv2d_g)

    spp_simple = build_simple(Spp, sv2d_g, periodic=periodic,
                              prolong_w=spp_prolong_w)

    # 2D multigrid for the depth-averaged saddle: the 9-point stencil as
    # the dk = 0 plane of a one-layer 27-point tensor
    spp_mg = None
    if spp_precond == "MG":
        Spp27 = An.new_zeros((27, 3, 3, 1, mw, nw))
        Spp27[:9, :, :, 0] = Spp
        spp_mg = _mg.build(Spp27, periodic=periodic,
                           prolong_w=spp_prolong_w)

    # rho/mu transform: Q = (1/sqrt 2) [[-1, lam], [1/lam, 1]] per (T, S)
    # pair, Q^2 = I; A_rhomu = Q A_TS Q is the pointwise 2x2 sandwich over
    # every stencil location
    Qts = ts_rm = ts_rm_binv = None
    if rhomu:
        lam = rhomu_lambda
        idet = 1.0 / np.sqrt(2.0)
        Qts = torch.as_tensor(np.array([[-idet, lam * idet],
                                        [idet / lam, idet]]), **kw)
        ts_rm = torch.einsum('ab,pbcxyz,cd->padxyz', Qts, sub_ts, Qts)
        ts_rm_binv = _column_block_inv(ts_rm)

    # validated TS null modes: const-T / const-S over ocean cells, gated
    # by the actual smallness of A v
    ts_scale = torch.clamp(g.amax(torch.abs(sub_ts)), min=1e-30)
    nulls = []
    for var in range(2):
        v = torch.zeros((2, l, m, n), **kw)
        v[var] = ocean
        vn = torch.clamp(g.norm(v), min=1e-30)
        Av = g.st(sub_ts, v)
        gate = g.norm(Av) < 1e-8 * ts_scale * vn
        nulls.append(gate.to(An.dtype) * v / vn)
    ts_null = torch.stack(nulls)

    # null modes of the transformed block: Q v (Q is an involution, not
    # orthogonal), re-orthonormalized by Gram-Schmidt
    ts_null_rm = None
    if rhomu:
        q0 = torch.einsum('ab,bxyz->axyz', Qts, ts_null[0])
        q1 = torch.einsum('ab,bxyz->axyz', Qts, ts_null[1])
        n0 = torch.clamp(g.norm(q0), min=1e-30)
        q0 = q0 / n0 * (n0 > 1e-15).to(An.dtype)
        q1 = q1 - g.sum(q0 * q1) * q0
        n1 = torch.clamp(g.norm(q1), min=1e-30)
        q1 = q1 / n1 * (n1 > 1e-15).to(An.dtype)
        ts_null_rm = torch.stack([q0, q1])

    uv_mg = ts_mg = None
    if uv_precond == "MG":
        uv_mg = _mg.build(sub_uv, periodic=periodic, prolong_w=uv_prolong_w,
                          grid=g)
    if ts_precond == "MG":
        ts_mg = _mg.build(ts_rm if rhomu else sub_ts, periodic=periodic,
                          prolong_w=ts_prolong_w, grid=g)
    uv_xinv, uv_xdummy = g.xline_inv(sub_uv)

    ap_binv, ap_dummy = _column_tridiag_factor(
        An[4, _W, _P], An[13, _W, _P], An[22, _W, _P])
    aw_binv, aw_dummy = _column_tridiag_factor(
        An[4, _P, _W], An[13, _P, _W], An[22, _P, _W])

    # Dirichlet / identity rows: the sweep passes the residual through
    # (TRIOS_BlockPreconditioner.C:478-487)
    diag = torch.stack([An[4, a, a] for a in range(nun)])
    offsum = torch.sum(torch.abs(An), dim=(0, 2)) - torch.abs(diag)
    dir_mask = ((torch.abs(diag) > 0.0)
                & (offsum <= 1e-6 * torch.abs(diag))).to(An.dtype)
    dir_diag = torch.where(dir_mask > 0, diag, 1.0)

    return BGSPrec(
        A_uvuv=sub_uv, A_uvp=An[:, _UV, _P].contiguous(),
        A_puv=An[:, _P, _UV].contiguous(), A_tsts=sub_ts,
        A_tsuv=An[:, _TS, _UV].contiguous(),
        A_tsw=An[:, _TS, _W].contiguous(),
        A_wts=An[:, _W, _TS].contiguous(),
        Spp=Spp, Spp_binv=Spp_binv, uv_binv=uv_binv, ts_binv=ts_binv,
        uv_xinv=uv_xinv, uv_xdummy=uv_xdummy,
        ap_binv=ap_binv, ap_dummy=ap_dummy,
        aw_binv=aw_binv, aw_dummy=aw_dummy,
        svp=svp, sv2d=sv2d, spp_simple=spp_simple,
        ts_null=ts_null, dir_mask=dir_mask, dir_diag=dir_diag,
        uv_mg=uv_mg, ts_mg=ts_mg, spp_mg=spp_mg,
        Qts=Qts, ts_rm=ts_rm, ts_rm_binv=ts_rm_binv,
        ts_null_rm=ts_null_rm,
        ts_icoeff=icoeff, ts_iidx=iidx, ts_iscale=iscale)


class _Graphed:
    """fn(v) recorded once as a CUDA graph over a static input buffer;
    each call copies v in, replays, and returns a copy of the output.

    The saddle FGMRES applies the same ~400 small kernels (SIMPLE
    preconditioner, saddle operator) on every inner iteration, and
    launching them one by one from Python costs several times their
    device time; a replay launches them all at once."""

    @log.timed("BGS: record graphs", sync=True)
    def __init__(self, fn, example: torch.Tensor):
        self.inp = example.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(self.inp)        # warm-up: lazy index tables, cuBLAS handles
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(self.inp)
        log.count("graphs recorded")

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.inp.copy_(v)
        self.graph.replay()
        return self.out.clone()


class SweepGraphs:
    """The 3D saddle operator and its SIMPLE-type preconditioner of one
    factor set, recorded as CUDA graphs on the set's first sweep on the
    card.  The preconditioner's kernels depend on the saddle scheme
    (SI, SL, SR), so the recorded pairs are kept per scheme."""

    def __init__(self, prec: BGSPrec):
        self.prec = prec
        self.recorded: dict = {}      # scheme -> (mv, pc)

    def get(self, scheme: str, mv, pc, example: torch.Tensor):
        if scheme not in self.recorded:
            self.recorded[scheme] = (_Graphed(mv, example),
                                     _Graphed(pc, example))
        return self.recorded[scheme]


def _inner_fgmres(matvec, prec, b, tol, maxiter, reduce=None):
    res = fgmres_flat(matvec, prec, b.reshape(-1),
                      torch.zeros_like(b.reshape(-1)), tol, maxiter,
                      reduce=reduce)
    return res.x.reshape(b.shape)


@log.timed("BGS: sweep", sync=True)
def apply(prec: BGSPrec, r: torch.Tensor, *, periodic: bool,
          nit_spp: int = 30, nit_uv: int = 12, nit_ts: int = 0,
          spp_scheme: str = "SI", permutation: int = 1,
          symmetric: bool = False, tol_spp: float = 1e-6,
          tol_uv: float = 1e-2, tol_ts: float = 1e-2,
          graphs: SweepGraphs | None = None, grid=None) -> torch.Tensor:
    """Block-GS sweep z ~= J^{-1} r, in the dtype of r and the factors.

    permutation selects one of the reference's three block orderings
    M1/M2/M3 (TRIOS_BlockPreconditioner.H:93-99; SolveLower1/2/3,
    TRIOS_BlockPreconditioner.C:1479-1812); symmetric appends the
    SolveUpper backward correction (:1814-1917).  nit_uv/tol_uv belong to
    the separate Auv solve of the 2D-saddle branches (scheme KRYLOV, M2,
    M3).  graphs, for CUDA tensors, replays the 3D saddle iteration's
    kernels from graphs of this factor set instead of launching them one
    by one.  grid holds r and the factors (the factors' own, from
    :func:`build`; the whole grid by default).

    The sweep and each of its block solves are spans of
    ``utils.logging``; none lies inside a function a graph records, whose
    host code does not run at replay."""
    g = grid if grid is not None else _mg.Whole(periodic)
    _, l, m, n = r.shape
    mw, nw = g.shape(r)          # the whole grid's
    buv, bw, bp, bts = r[_UV], r[_W], r[_P], r[_TS]
    Nuv = 2 * l * m * n
    st = g.st

    @log.timed("BGS: Ap/Aw")
    def ap_solve(b):
        """ytilp = Ap \\ b: hydrostatic column solve (w rows, p col)."""
        return _apply_tridiag_inv(prec.ap_binv, prec.ap_dummy, b)

    @log.timed("BGS: Ap/Aw")
    def aw_solve(b):
        """yw = Aw \\ b: continuity column solve (p rows, w col)."""
        return _apply_tridiag_inv(prec.aw_binv, prec.aw_dummy, b)

    def p_deflate(p2):
        return deflate(p2, prec.sv2d, total=g.sum)

    # ---- the depth-averaged 2D saddle (scheme KRYLOV, M2, M3) --------
    # solved on the whole (3, m, n) field: its right-hand side is made
    # whole, its inner FGMRES sums over the whole field, and the solution
    # is cut back to grid's part
    def spp_mv(v):
        return _apply_2d(prec.Spp, v.reshape(3, mw, nw),
                         periodic).reshape(-1)

    def spp_pc(v):
        v3 = v.reshape(3, mw, nw)
        if spp_scheme in ("SI", "SL", "SR"):
            z = apply_simple(prec.spp_simple, v3, periodic=periodic,
                             scheme=spp_scheme)
        elif prec.spp_mg is not None:
            z = _mg.apply(prec.spp_mg, v3[:, None], periodic=periodic)[:, 0]
        else:
            z = torch.bmm(prec.Spp_binv,
                          v3.permute(1, 2, 0).reshape(mw * nw, 3, 1)
                          ).reshape(mw, nw, 3).permute(2, 0, 1)
        # deflate the barotropic pressure null modes (const +
        # checkerboard) so the inner Krylov never grows them
        return torch.cat([z[:2], deflate(
            z[2], prec.spp_simple.nullmodes)[None]]).reshape(-1)

    @log.timed("BGS: saddle")
    def spp_solve(ruv, rp):
        rbar = g.whole(torch.cat([ruv.mean(dim=1), rp.mean(dim=1)]))
        zbar = spp_pc(rbar.reshape(-1)) if nit_spp == 0 \
            else _inner_fgmres(spp_mv, spp_pc, rbar, tol_spp, nit_spp)
        return g.local(zbar.reshape(3, mw, nw))

    # ---- the 3D saddle of SolveLower1 --------------------------------
    def lift(pbar):
        return pbar.expand(1, l, m, n)

    def dmean(uvl, w=None):
        return st(prec.A_puv, uvl, w)[0].mean(dim=0)

    def s3_mv(v):
        uvl = v[:Nuv].reshape(2, l, m, n)
        w = g.windows(uvl)
        yuv = st(prec.A_uvuv, uvl, w) \
            + st(prec.A_uvp, lift(v[Nuv:].reshape(m, n)))
        return torch.cat([yuv.reshape(-1), dmean(uvl, w).reshape(-1)])

    def chat_vcycle(b2):
        """One Chat V-cycle (the reference solves Chat with
        AztecOO+Ifpack, TRIOS_Saddlepoint.H:259-276), on the whole 2D
        field."""
        sp = prec.spp_simple
        z = _mg.apply2d(sp.chat_mg, deflate(g.whole(b2), sp.nullmodes),
                        periodic=periodic)
        return g.local(deflate(z, sp.nullmodes))

    def ahat(ruv):
        """Column solve, then a zonal line correction (the polar u/v
        ring modes are invisible to the column blocks)."""
        u = apply_col_inv(prec.uv_binv, ruv)
        res = ruv - st(prec.A_uvuv, u)
        return u + g.xline(prec.uv_xinv, prec.uv_xdummy, res)

    def s3_pc(v):
        """SIMPLE / SIMPLE(L) / SIMPLER preconditioner of the 3D saddle
        (TRIOS_Saddlepoint.H SppSimplePrec)."""
        ruv = v[:Nuv].reshape(2, l, m, n)
        rp = v[Nuv:].reshape(m, n)
        if spp_scheme == "SR":
            # SIMPLER: a pressure prediction from the momentum residual
            p0 = chat_vcycle(dmean(ahat(ruv)) - rp)
            ruv = ruv - st(prec.A_uvp, lift(p0))
        else:
            p0 = torch.zeros_like(rp)
        ustar = ahat(ruv)
        dp = chat_vcycle(dmean(ustar) - rp)
        u = ustar if spp_scheme == "SL" \
            else ustar - ahat(st(prec.A_uvp, lift(dp)))
        return torch.cat([u.reshape(-1), p_deflate(p0 + dp).reshape(-1)])

    @log.timed("BGS: saddle")
    def spp_solve3(ruv3, bp3):
        rhs = torch.cat([ruv3.reshape(-1),
                         p_deflate(bp3[0].mean(dim=0)).reshape(-1)])
        if nit_spp == 0:
            sol = s3_pc(rhs)
        else:
            mv, pc = s3_mv, s3_pc
            if graphs is not None:
                mv, pc = graphs.get(spp_scheme, s3_mv, s3_pc, rhs)
            sol = _inner_fgmres(mv, pc, rhs, tol_spp, nit_spp, g.reduce)
        return (sol[:Nuv].reshape(2, l, m, n),
                p_deflate(sol[Nuv:].reshape(m, n)))

    # ---- the separate momentum solve of the 2D-saddle branches -------
    def uv_mv(v):
        return st(prec.A_uvuv, v.reshape(2, l, m, n)).reshape(-1)

    def uv_pc(v):
        v4 = v.reshape(2, l, m, n)
        z = _mg.apply(prec.uv_mg, v4, periodic=periodic, grid=g) \
            if prec.uv_mg is not None else apply_col_inv(prec.uv_binv, v4)
        return z.reshape(-1)

    @log.timed("BGS: Auv")
    def auv_solve(b):
        if nit_uv == 0:
            return uv_pc(b.reshape(-1)).reshape(b.shape)
        return _inner_fgmres(uv_mv, uv_pc, b, tol_uv, nit_uv, g.reduce)

    # ---- tracers -----------------------------------------------------
    def ts_row_fix(y, v4):
        """The integral-condition row inside the ATS operator."""
        if prec.ts_icoeff is not None:
            g.put(y[1], prec.ts_iidx,
                  prec.ts_iscale * g.sum(prec.ts_icoeff * v4))
        return y

    def ts_proj(z4):
        for q in range(2):
            sv = prec.ts_null[q]
            z4 = z4 - g.sum(sv * z4) * sv
        return z4

    def ts_meanS_fix(z4, r4):
        """Exact rank-one action on the const-S direction, consistent
        with the integral-condition row (see the JAX module)."""
        if prec.ts_icoeff is None:
            return z4
        sv = prec.ts_null[1]
        denom = prec.ts_iscale * g.sum(prec.ts_icoeff * sv)
        big = torch.abs(denom) > 1e-30
        alpha = torch.where(big, g.at(r4[1], prec.ts_iidx)
                            / torch.where(big, denom, 1.0), 0.0)
        return z4 + alpha * sv

    def ts_mv(v):
        v4 = v.reshape(2, l, m, n)
        return ts_row_fix(st(prec.A_tsts, v4), v4).reshape(-1)

    def ts_pc(v):
        v4 = v.reshape(2, l, m, n)
        z = _mg.apply(prec.ts_mg, v4, periodic=periodic, grid=g) \
            if prec.ts_mg is not None else apply_col_inv(prec.ts_binv, v4)
        return ts_meanS_fix(ts_proj(z), v4).reshape(-1)

    def q_mul(v4):
        return torch.einsum('ab,bkji->akji', prec.Qts, v4)

    # rho/mu path (SolveATS with QTS, TRIOS_BlockPreconditioner.C:
    # 1919-1970): solve A_rhomu (Q y) = Q b and return y = Q (Q y).  The
    # operator is applied as Q (A_rowfix (Q v)) so the integral-condition
    # row stays in; the null modes are projected out of the final,
    # untransformed output only.
    def rm_mv(v):
        u4 = q_mul(v.reshape(2, l, m, n))
        return q_mul(ts_row_fix(st(prec.A_tsts, u4), u4)).reshape(-1)

    def rm_pc(v):
        v4 = v.reshape(2, l, m, n)
        z = _mg.apply(prec.ts_mg, v4, periodic=periodic, grid=g) \
            if prec.ts_mg is not None \
            else apply_col_inv(prec.ts_rm_binv, v4)
        return z.reshape(-1)

    @log.timed("BGS: ATS")
    def ats_solve(b):
        if prec.ts_rm is not None:
            qb = q_mul(b)
            qz = rm_pc(qb.reshape(-1)) if nit_ts == 0 \
                else _inner_fgmres(rm_mv, rm_pc, qb, tol_ts, nit_ts, g.reduce)
            y = q_mul(qz.reshape(2, l, m, n))
            return ts_meanS_fix(ts_proj(y), b)
        if nit_ts == 0:
            return ts_pc(b.reshape(-1)).reshape(b.shape)
        return _inner_fgmres(ts_mv, ts_pc, b, tol_ts, nit_ts, g.reduce)

    def prescorr(yp):
        for q in range(2):
            sv = prec.svp[q]
            yp = yp - g.sum(sv * yp[0]) * sv[None]
        return yp

    # ---- forward sweeps (SolveLower1/2/3) ----------------------------
    if permutation == 1:
        # M1: [Ap | Spp | Aw | ATS], pressure first, tracers last
        ytilp = ap_solve(bw)
        ruv = buv - st(prec.A_uvp, ytilp)
        if spp_scheme == "KRYLOV":
            # legacy 2D depth-averaged saddle and a separate Auv solve
            zbar = spp_solve(ruv, bp)
            yp = prescorr(ytilp + zbar[2][None, None])
            yuv = auv_solve(buv - st(prec.A_uvp, yp))
        else:
            # the reference's structure: yuv comes from the 3D saddle
            yuv, pbar = spp_solve3(ruv, bp)
            yp = prescorr(ytilp + pbar[None, None])
        w = g.windows(yuv)
        yw = aw_solve(bp - st(prec.A_puv, yuv, w))
        yts = ats_solve(bts - st(prec.A_tsuv, yuv, w) - st(prec.A_tsw, yw))
    elif permutation == 2:
        # M2 (SolveLower2): Spp first (no pressure pre-elimination), then
        # continuity, tracers, and pressure last with the buoyancy
        # back-coupling; the depth-averaged momentum is lifted by the 3D
        # momentum solve on buv less the barotropic pressure gradient
        zbar = spp_solve(buv, bp)
        yuv = auv_solve(buv - st(prec.A_uvp, lift(zbar[2])))
        w = g.windows(yuv)
        yw = aw_solve(bp - st(prec.A_puv, yuv, w))
        yts = ats_solve(bts - st(prec.A_tsuv, yuv, w) - st(prec.A_tsw, yw))
        ytilp = ap_solve(bw - st(prec.A_wts, yts))
        yp = prescorr(ytilp + zbar[2][None, None])
    elif permutation == 3:
        # M3 (SolveLower3): continuity first, then tracers, hydrostatic
        # pressure (with buoyancy), and the saddle point last
        yw = aw_solve(bp)
        yts = ats_solve(bts - st(prec.A_tsw, yw))
        ytilp = ap_solve(bw - st(prec.A_wts, yts))
        zbar = spp_solve(buv - st(prec.A_uvp, ytilp), bp)
        yp = prescorr(ytilp + zbar[2][None, None])
        yuv = auv_solve(buv - st(prec.A_uvp, yp))
    else:
        raise ValueError(f"BGS: invalid permutation {permutation}")

    # ---- backward correction (SolveUpper, symmetric GS) --------------
    if symmetric and permutation != 1:
        # the correction below is the strictly-upper factor of the M1
        # ordering only (the reference has symmetric GS disabled)
        raise ValueError("BGS: symmetric Gauss-Seidel requires "
                         "permutation == 1")
    if symmetric:
        # x = U \ y with U the strictly-upper coupling of M1:
        #   zp  = Ap \ (BwTS yTS)
        #   zuv ~ Auv \ (Guv zp)      (one column-block application)
        #   zw  = Aw \ (Duv zuv)
        #   xuv = yuv + zuv; xw = yw - zw; xp = yp - zp; xTS = yTS
        zp = ap_solve(st(prec.A_wts, yts))
        zuv = apply_col_inv(prec.uv_binv, st(prec.A_uvp, zp))
        zw = aw_solve(st(prec.A_puv, zuv))
        yuv = yuv + zuv
        yw = yw - zw
        yp = prescorr(yp - zp)

    z = torch.cat([yuv, yw, yp, yts])
    # identity action on Dirichlet rows: z_i = r_i / a_ii
    dm = prec.dir_mask
    return z * (1.0 - dm) + dm * r / prec.dir_diag
