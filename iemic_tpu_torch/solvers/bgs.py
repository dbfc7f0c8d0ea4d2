"""Physics-based block Gauss-Seidel preconditioner (De Niet & Wubs),
PyTorch.

Port of ``iemic_tpu/solvers/bgs.py`` (the reference's tailored ocean
preconditioner, TRIOS_BlockPreconditioner.H:36-100, sweep
TRIOS_BlockPreconditioner.C:1479-1611 SolveLower1) for the configuration
every shipped bundle uses: permutation M1, plain Gauss-Seidel, the 3D
saddle solved by FGMRES with the SIMPLE ('SI') preconditioner, and a
semicoarsened multigrid on the tracer block ATS.  One sweep:

  1. baroclinic pressure   ytilp = Ap \\ b_w            (column solves)
  2. 3D saddle             [Auv Guv*lift; mean(Duv .) 0] [yuv, pbar]
  3. full pressure         y_p = ytilp + pbar, checkerboard-projected
  4. vertical velocity     y_w = Aw \\ (b_p - Duv y_uv)  (column solves)
  5. tracers               y_TS = ATS \\ (b_TS - BTSuv y_uv - BTSw y_w)

Every block stays a slice of the stencil tensor; the slices the sweep
applies are cut once in :func:`build`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.stencil import UU, VV, WW, PP, TT, SS, apply_stencil
from . import mg as _mg
from .fgmres import fgmres_flat
from .preconditioner import (inv, column_blocks, to_columns, from_columns,
                             apply_col_inv)
from .saddlepoint import build_simple, deflate

_UV = slice(UU, VV + 1)
_TS = slice(TT, SS + 1)
_W = slice(WW, WW + 1)
_P = slice(PP, PP + 1)
_UVP = [UU, VV, PP]

_BRANCHES = "ROADMAP queue 1 item 5 (non-bundle BGS branches)"


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


class BGSPrec(NamedTuple):
    """Factored state of the block-GS preconditioner."""
    A_uvuv: torch.Tensor      # (27, 2, 2, l, m, n) sub-blocks of An
    A_uvp: torch.Tensor       # (27, 2, 1, ...)
    A_puv: torch.Tensor       # (27, 1, 2, ...)
    A_tsts: torch.Tensor      # (27, 2, 2, ...)
    A_tsuv: torch.Tensor      # (27, 2, 2, ...)
    A_tsw: torch.Tensor       # (27, 2, 1, ...)
    uv_binv: torch.Tensor     # (m*n, 2l, 2l) Auv column-block inverses
    uv_xinv: torch.Tensor     # zonal line inverses of Auv (saddle Ahat)
    uv_xdummy: torch.Tensor
    ap_binv: torch.Tensor     # (m*n, l, l) hydrostatic (w rows, p col)
    ap_dummy: torch.Tensor
    aw_binv: torch.Tensor     # (m*n, l, l) continuity (p rows, w col)
    aw_dummy: torch.Tensor
    svp: torch.Tensor         # (2, l, m, n) pressure null modes
    sv2d: torch.Tensor        # (2, m, n) barotropic null modes
    spp_simple: object        # saddlepoint.SppSimple
    ts_mg: object             # mg.MGPrec on ATS
    ts_null: torch.Tensor     # (2, 2, l, m, n) validated TS null modes
    dir_mask: torch.Tensor    # (6, l, m, n) 1.0 on pure-diagonal rows
    dir_diag: torch.Tensor    # (6, l, m, n) their diagonal values
    # salinity integral-condition row threaded into the ATS operator
    # (THCM.C:2121-2196): coefficients, (k, j, i), row scale * int_sign
    ts_icoeff: torch.Tensor | None = None
    ts_iidx: tuple | None = None
    ts_iscale: torch.Tensor | None = None


def build(An: torch.Tensor, landm: np.ndarray, *, periodic: bool,
          spp_scheme: str = "SI", rhomu: bool = False,
          uv_precond: str = "Columns", ts_precond: str = "MG",
          spp_precond: str = "Jacobi", int_row=None,
          prolong_w: float = 0.25) -> BGSPrec:
    """Factor the preconditioner from the (row-scaled) stencil tensor.

    int_row: optional (coeff (6, l, m, n), (var, k, j, i), scale), the
    outer operator's salinity integral-condition row, threaded into the
    ATS inner operator so the subsolve is nonsingular.  landm is the
    padded (l+2, m+2, n+2) land mask."""
    if spp_scheme != "SI" or rhomu or uv_precond != "Columns" \
            or ts_precond != "MG" or spp_precond != "Jacobi":
        raise NotImplementedError(
            f"BGS with scheme={spp_scheme} rhomu={rhomu} "
            f"Auv={uv_precond} ATS={ts_precond} Spp={spp_precond}: "
            + _BRANCHES)
    _, nun, _, l, m, n = An.shape
    kw = dict(dtype=An.dtype, device=An.device)
    ocean = torch.as_tensor(
        (np.asarray(landm)[1:l + 1, 1:m + 1, 1:n + 1] == 0), **kw)
    if int_row is not None:
        coeff, (var, k, j, i), scale = int_row
        icoeff = torch.as_tensor(coeff, **kw)[_TS].contiguous()
        iidx = (int(k), int(j), int(i))
        iscale = torch.as_tensor(scale, **kw)
    else:
        icoeff = iidx = iscale = None

    # ---- depth-averaged 2D saddle over (u, v, p) (uniform weights) --
    sub = An[:, _UVP][:, :, _UVP]                # (27, 3, 3, l, m, n)
    w = torch.full((l,), 1.0 / l, **kw)
    Spp = torch.einsum('pABkji,k->pABji',
                       sub[:9] + sub[9:18] + sub[18:27], w)

    sub_uv = An[:, _UV, _UV].contiguous()
    uv_binv = _column_block_inv(sub_uv)

    # pressure null modes (constant + checkerboard over ocean points,
    # TRIOS_BlockPreconditioner.H:489-494) and their 2D shadows
    ij = (np.arange(m)[:, None] + np.arange(n)[None, :]) % 2
    cbpat = torch.as_tensor(np.where(ij == 0, 1.0, -1.0), **kw)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v), min=1e-300)

    svp = torch.stack([unit(ocean), unit(ocean * cbpat)])
    wet = torch.amax(ocean, dim=0)
    sv2d = torch.stack([unit(wet), unit(wet * cbpat)])

    spp_simple = build_simple(Spp, sv2d, periodic=periodic,
                              prolong_w=prolong_w)

    # validated TS null modes: const-T / const-S over ocean cells, gated
    # by the actual smallness of A v
    sub_ts = An[:, _TS, _TS].contiguous()
    ts_scale = torch.clamp(torch.amax(torch.abs(sub_ts)), min=1e-30)
    nulls = []
    for var in range(2):
        v = torch.zeros((2, l, m, n), **kw)
        v[var] = ocean
        vn = torch.clamp(torch.linalg.norm(v), min=1e-30)
        Av = apply_stencil(sub_ts, v, periodic=periodic)
        gate = torch.linalg.norm(Av) < 1e-8 * ts_scale * vn
        nulls.append(gate.to(An.dtype) * v / vn)
    ts_null = torch.stack(nulls)

    ts_mg = _mg.build(sub_ts, periodic=periodic, prolong_w=prolong_w)
    uv_xinv, uv_xdummy = _mg._xline_inv(sub_uv, periodic=periodic)

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
        uv_binv=uv_binv, uv_xinv=uv_xinv, uv_xdummy=uv_xdummy,
        ap_binv=ap_binv, ap_dummy=ap_dummy,
        aw_binv=aw_binv, aw_dummy=aw_dummy,
        svp=svp, sv2d=sv2d, spp_simple=spp_simple, ts_mg=ts_mg,
        ts_null=ts_null, dir_mask=dir_mask, dir_diag=dir_diag,
        ts_icoeff=icoeff, ts_iidx=iidx, ts_iscale=iscale)


class _Graphed:
    """fn(v) recorded once as a CUDA graph over a static input buffer;
    each call copies v in, replays, and returns a copy of the output.

    The saddle FGMRES applies the same ~400 small kernels (SIMPLE
    preconditioner, saddle operator) on every inner iteration, and
    launching them one by one from Python costs several times their
    device time; a replay launches them all at once."""

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

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.inp.copy_(v)
        self.graph.replay()
        return self.out.clone()


class SweepGraphs:
    """The saddle operator and SIMPLE preconditioner of one factor set,
    each recorded as a CUDA graph on the set's first sweep on the card."""

    def __init__(self, prec: BGSPrec):
        self.prec = prec
        self.mv = self.pc = None


def _inner_fgmres(matvec, prec, b, tol, maxiter):
    res = fgmres_flat(matvec, prec, b.reshape(-1),
                      torch.zeros_like(b.reshape(-1)), tol, maxiter)
    return res.x.reshape(b.shape)


def apply(prec: BGSPrec, r: torch.Tensor, *, periodic: bool,
          nit_spp: int = 60, nit_uv: int = 12, nit_ts: int = 0,
          spp_scheme: str = "SI", permutation: int = 1,
          symmetric: bool = False, tol_spp: float = 1e-8,
          tol_uv: float = 1e-2, tol_ts: float = 1e-2,
          graphs: SweepGraphs | None = None) -> torch.Tensor:
    """Block-GS sweep z ~= J^{-1} r (M1 ordering, SolveLower1).  Works in
    the dtype of r and the factors.  nit_uv/tol_uv belong to the legacy
    separate Auv solve, which the 3D saddle replaces.  graphs, for
    CUDA tensors, replays the saddle iteration's kernels from graphs of
    this factor set instead of launching them one by one."""
    if spp_scheme != "SI" or permutation != 1 or symmetric:
        raise NotImplementedError(
            f"BGS sweep scheme={spp_scheme} permutation={permutation} "
            f"symmetric={symmetric}: " + _BRANCHES)
    _, l, m, n = r.shape
    buv, bw, bp, bts = r[_UV], r[_W], r[_P], r[_TS]
    Nuv = 2 * l * m * n

    def st(A, x):
        return apply_stencil(A, x, periodic=periodic)

    def lift(pbar):
        return pbar.expand(1, l, m, n)

    def dmean(uvl):
        return st(prec.A_puv, uvl)[0].mean(dim=0)

    def p_deflate(p2):
        return deflate(p2, prec.sv2d)

    def s3_mv(v):
        uvl = v[:Nuv].reshape(2, l, m, n)
        yuv = st(prec.A_uvuv, uvl) \
            + st(prec.A_uvp, lift(v[Nuv:].reshape(m, n)))
        return torch.cat([yuv.reshape(-1), dmean(uvl).reshape(-1)])

    def chat_vcycle(b2):
        """One Chat V-cycle (the reference solves Chat with
        AztecOO+Ifpack, TRIOS_Saddlepoint.H:259-276)."""
        z = _mg.apply2d(prec.spp_simple.chat_mg, p_deflate(b2),
                        periodic=periodic)
        return p_deflate(z)

    def ahat(ruv):
        """Column solve, then a zonal line correction (the polar u/v
        ring modes are invisible to the column blocks)."""
        u = apply_col_inv(prec.uv_binv, ruv)
        res = ruv - st(prec.A_uvuv, u)
        rx = res.reshape(2 * l * m, n).masked_fill(prec.uv_xdummy, 0.0)
        return u + torch.bmm(prec.uv_xinv,
                             rx.unsqueeze(-1)).reshape(2, l, m, n)

    def s3_pc(v):
        """SIMPLE preconditioner of the 3D saddle."""
        ustar = ahat(v[:Nuv].reshape(2, l, m, n))
        dp = chat_vcycle(dmean(ustar) - v[Nuv:].reshape(m, n))
        u = ustar - ahat(st(prec.A_uvp, lift(dp)))
        return torch.cat([u.reshape(-1), p_deflate(dp).reshape(-1)])

    def spp_solve3(ruv3, bp3):
        rhs = torch.cat([ruv3.reshape(-1),
                         p_deflate(bp3[0].mean(dim=0)).reshape(-1)])
        if nit_spp == 0:
            sol = s3_pc(rhs)
        else:
            mv, pc = s3_mv, s3_pc
            if graphs is not None:
                if graphs.mv is None:
                    graphs.mv = _Graphed(s3_mv, rhs)
                    graphs.pc = _Graphed(s3_pc, rhs)
                mv, pc = graphs.mv, graphs.pc
            sol = _inner_fgmres(mv, pc, rhs, tol_spp, nit_spp)
        return (sol[:Nuv].reshape(2, l, m, n),
                p_deflate(sol[Nuv:].reshape(m, n)))

    def ts_proj(z4):
        for q in range(2):
            sv = prec.ts_null[q]
            z4 = z4 - torch.sum(sv * z4) * sv
        return z4

    def ts_meanS_fix(z4, r4):
        """Exact rank-one action on the const-S direction, consistent
        with the integral-condition row (see the JAX module)."""
        if prec.ts_icoeff is None:
            return z4
        sv = prec.ts_null[1]
        k, j, i = prec.ts_iidx
        denom = prec.ts_iscale * torch.sum(prec.ts_icoeff * sv)
        big = torch.abs(denom) > 1e-30
        alpha = torch.where(big, r4[1, k, j, i]
                            / torch.where(big, denom, 1.0), 0.0)
        return z4 + alpha * sv

    def ts_mv(v):
        v4 = v.reshape(2, l, m, n)
        y = st(prec.A_tsts, v4)
        if prec.ts_icoeff is not None:
            # the integral-condition row inside the ATS operator
            y[(1,) + prec.ts_iidx] = prec.ts_iscale \
                * torch.sum(prec.ts_icoeff * v4)
        return y.reshape(-1)

    def ts_pc(v):
        v4 = v.reshape(2, l, m, n)
        z = _mg.apply(prec.ts_mg, v4, periodic=periodic)
        return ts_meanS_fix(ts_proj(z), v4).reshape(-1)

    def ats_solve(b):
        if nit_ts == 0:
            return ts_pc(b.reshape(-1)).reshape(b.shape)
        return _inner_fgmres(ts_mv, ts_pc, b, tol_ts, nit_ts)

    def prescorr(yp):
        for q in range(2):
            sv = prec.svp[q]
            yp = yp - torch.sum(sv * yp[0]) * sv[None]
        return yp

    ytilp = _apply_tridiag_inv(prec.ap_binv, prec.ap_dummy, bw)
    ruv = buv - st(prec.A_uvp, ytilp)
    yuv, pbar = spp_solve3(ruv, bp)
    yp = prescorr(ytilp + pbar[None, None])
    yw = _apply_tridiag_inv(prec.aw_binv, prec.aw_dummy,
                            bp - st(prec.A_puv, yuv))
    yts = ats_solve(bts - st(prec.A_tsuv, yuv) - st(prec.A_tsw, yw))

    z = torch.cat([yuv, yw, yp, yts])
    # identity action on Dirichlet rows: z_i = r_i / a_ii
    dm = prec.dir_mask
    return z * (1.0 - dm) + dm * r / prec.dir_diag
