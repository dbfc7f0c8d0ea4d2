"""Semicoarsened geometric multigrid for stencil sub-blocks (PyTorch).

Port of ``iemic_tpu/solvers/mg.py`` (the stand-in for the reference's ML
smoothed-aggregation multigrid, ocean_preconditioner_params.xml:66-120,
:578-584):

  * 3D: 2x2 horizontal aggregation only (z never coarsened), damped
    alternating-line smoother (vertical column blocks, then zonal
    x-lines), piecewise-constant Galerkin coarse operators, a dense
    Tikhonov-shifted inverse at the coarsest level;
  * 2D: the same for a scalar 25-point stencil — the Chat pressure Schur
    complement of the SIMPLE saddle preconditioner.

The coarsest dense matrices are assembled by scattering the stencil
coefficients into place (the JAX package applied the operator to the
identity under ``vmap``).

The 3D hierarchy reaches its finest level's grid through a grid-operations
object (:class:`Whole`, the whole grid on one device): the stencil
product, the zonal line solve, the restriction, the prolongation, the
Galerkin coarsening and the whole of a field.  ``parallel.bgs``'s
``PartitionedGrid`` is one rank's block of the grid; the coarser levels
are always whole.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stencil_hopper
from ..ops.stencil import offsets, windows
from .preconditioner import (inv, column_blocks, to_columns,
                             from_columns)

_OFFS = offsets()


def _p_index(di: int, dj: int, dk: int) -> int:
    """Stencil location of offset (di, dj, dk) (inverse of offsets())."""
    return 3 * (di + 1) + (dj + 1) + 9 * (0 if dk == 0 else
                                          (1 if dk == -1 else 2))


def _pad_hv(An: torch.Tensor, mpad: int, npad: int) -> torch.Tensor:
    """Zero-pad (..., m, n) by (mpad, npad) at the high end."""
    if mpad == 0 and npad == 0:
        return An
    return F.pad(An, (0, npad, 0, mpad))


def coarsen_stencil(An: torch.Tensor, *, periodic: bool) -> torch.Tensor:
    """Galerkin coarse stencil R A P with piecewise-constant R/P over 2x2
    horizontal aggregates: (27, nv, nv, l, m, n), m and n even ->
    (27, nv, nv, l, m//2, n//2).  Fine offset (di, dj, dk) from parity
    (b, a) lands on coarse neighbour ((b+di)>>1, (a+dj)>>1, dk)."""
    _, nva, nvb, l, m, n = An.shape
    mc, nc = m // 2, n // 2
    Ar = An.reshape(27, nva, nvb, l, mc, 2, nc, 2)
    out = An.new_zeros((27, nva, nvb, l, mc, nc))
    for p in range(27):
        di, dj, dk = (int(v) for v in _OFFS[p])
        for a in range(2):
            for b in range(2):
                out[_p_index((b + di) >> 1, (a + dj) >> 1, dk)] += \
                    Ar[p, :, :, :, :, a, :, b]
    return out


def _column_inv(An: torch.Tensor, *, eps=1e-12):
    """Batched inverses of the vertical column blocks (the line
    smoother); returns (binv (m*n, d, d), dummy (m*n, d))."""
    _, nv, _, l, m, n = An.shape
    d = nv * l
    B = column_blocks(An[4], An[13], An[22])
    dummy = torch.amax(torch.abs(B), dim=2) < eps
    B = B + torch.diag_embed(dummy.to(B.dtype))
    return inv(B), dummy


def xline_bands(An: torch.Tensor) -> torch.Tensor:
    """The three bands (3, nv, l, m, n) of the per-variable x-lines:
    stencil locations 1/4/7 (di = -1, 0, 1; dj = dk = 0)."""
    idx = torch.arange(An.shape[1], device=An.device)
    return torch.stack([An[1][idx, idx], An[4][idx, idx], An[7][idx, idx]])


def _xline_inv(An: torch.Tensor, *, periodic: bool, eps=1e-12):
    """Batched inverses of the per-variable x-line (cyclic) tridiagonal
    blocks (stencil locations 1/4/7, dj=dk=0): (xinv (nv*l*m, n, n),
    dummy (nv*l*m, n))."""
    return _xline_bands_inv(xline_bands(An), periodic=periodic, eps=eps)


def _xline_bands_inv(bands: torch.Tensor, *, periodic: bool, eps=1e-12):
    """:func:`_xline_inv` from the bands (3, nv, l, m, n) of whole
    lines."""
    lo, dg, hi = bands
    nv, l, m, n = dg.shape
    B = dg.new_zeros((nv, l, m, n, n))
    ii = torch.arange(n, device=dg.device)
    B[..., ii, ii] = dg
    B[..., ii[1:], ii[:-1]] = lo[..., 1:]
    B[..., ii[:-1], ii[1:]] = hi[..., :-1]
    if periodic:
        B[..., 0, n - 1] = lo[..., 0]
        B[..., n - 1, 0] = hi[..., n - 1]
    B = B.reshape(nv * l * m, n, n)
    dummy = torch.amax(torch.abs(B), dim=2) < eps
    B = B + torch.diag_embed(dummy.to(B.dtype))
    return inv(B), dummy


def _stencil_to_dense(An: torch.Tensor, periodic: bool) -> torch.Tensor:
    """Dense (N, N) matrix of a small stencil tensor in the natural
    (nv, l, m, n) ordering (the coarsest-level factor only)."""
    _, nv, _, l, m, n = An.shape
    N = nv * l * m * n
    A = An.new_zeros(N * N)
    dev = An.device
    k = torch.arange(l, device=dev)[:, None, None]
    j = torch.arange(m, device=dev)[None, :, None]
    i = torch.arange(n, device=dev)[None, None, :]
    var = torch.arange(nv, device=dev)
    for p in range(27):
        di, dj, dk = (int(v) for v in _OFFS[p])
        k2, j2, i2 = k + dk, j + dj, i + di
        valid = (k2 >= 0) & (k2 < l) & (j2 >= 0) & (j2 < m)
        if periodic:
            i2 = i2 % n
        else:
            valid = valid & (i2 >= 0) & (i2 < n)
        valid = valid.expand(l, m, n)
        pt = ((k * m + j) * n + i).expand(l, m, n)[valid]
        pt2 = ((k2 * m + j2) * n + i2).expand(l, m, n)[valid]
        rows = var[:, None, None] * (l * m * n) + pt
        cols = var[None, :, None] * (l * m * n) + pt2
        vals = An[p][:, :, valid]                  # (nv, nv, npts)
        A.index_put_(((rows * N + cols).reshape(-1),),
                     vals.reshape(-1), accumulate=True)
    return A.reshape(N, N)


def _shifted_dense_inv(A: torch.Tensor) -> torch.Tensor:
    """Gauge empty rows, shift against exact singularity, invert."""
    N = A.shape[0]
    scale = torch.amax(torch.abs(A))
    rowmax = torch.amax(torch.abs(A), dim=1)
    empty = (rowmax < 1e-12 * torch.clamp(scale, min=1e-30)).to(A.dtype)
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    return inv(A + torch.diag(empty) + 1e-12 * scale * eye)


class MGLevel(NamedTuple):
    An: torch.Tensor
    binv: torch.Tensor
    dummy: torch.Tensor
    # zonal line inverses of the alternating-line smoother, (nv*l*m, n, n)
    # and (nv*l*m, n); None when the hierarchy was built without them
    xinv: torch.Tensor | None = None
    xdummy: torch.Tensor | None = None


class MGPrec(NamedTuple):
    levels: tuple            # MGLevel, fine -> coarse
    coarse_inv: torch.Tensor  # dense inverse at the coarsest level
    damping: float
    pw: float                # prolongation neighbour weight


class Whole:
    """The grid operations of the 3D multigrid's finest level and of the
    BGS sweep, on the whole grid on one device: the stencil windows and
    their contraction, sums, norms and maxima over the grid, the zonal
    line solve, the restriction, prolongation and Galerkin coarsening of
    the 2x2 aggregates, and the whole of a field (the field itself).
    ``parallel.bgs.PartitionedGrid`` has the same methods on one rank's
    block."""

    reduce = None            # the sum over ranks of fgmres_flat

    def __init__(self, periodic: bool):
        self.periodic = periodic

    def windows(self, x: torch.Tensor) -> torch.Tensor | None:
        """The 27 windows of x, for :meth:`st` to share between products
        of x; None on the card, where st's kernel reads x itself."""
        return None if x.is_cuda else windows(x, self.periodic)

    def st(self, A: torch.Tensor, x: torch.Tensor, w=None) -> torch.Tensor:
        """The stencil product A x of a sub-block A
        (``ops.stencil_hopper.apply_block``: the Hopper kernel on the
        card, the plain expression on the CPU); w, the windows of x,
        where another product took them already."""
        return stencil_hopper.apply_block(A, x, periodic=self.periodic,
                                          w=w)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sum(t)

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        return torch.linalg.norm(v)

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        return torch.amax(t)

    def shape(self, x: torch.Tensor) -> tuple[int, int]:
        """The grid's (m, n) of a field on it."""
        return tuple(x.shape[-2:])

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def at(self, x: torch.Tensor, idx: tuple) -> torch.Tensor:
        """The value of an (l, m, n) field at the grid point idx."""
        return x[idx]

    def put(self, y: torch.Tensor, idx: tuple, value) -> None:
        """Set an (l, m, n) field at the grid point idx."""
        y[idx] = value

    def xline_inv(self, An: torch.Tensor):
        return _xline_inv(An, periodic=self.periodic)

    def xline(self, xinv, xdummy, res: torch.Tensor) -> torch.Tensor:
        """The zonal line solve of res (nv, l, m, n) by the inverses of
        :meth:`xline_inv`."""
        rx = res.reshape(-1, res.shape[-1]).masked_fill(xdummy, 0.0)
        return torch.bmm(xinv, rx.unsqueeze(-1)).reshape(res.shape)

    def coarsen(self, An: torch.Tensor) -> torch.Tensor:
        m, n = An.shape[-2:]
        return coarsen_stencil(_pad_hv(An, m % 2, n % 2),
                               periodic=self.periodic)

    def restrict(self, res: torch.Tensor) -> torch.Tensor:
        return _restrict(res)

    def prolong(self, zc: torch.Tensor, like: torch.Tensor, w: float
                ) -> torch.Tensor:
        """The prolongation of the coarse zc onto the grid of like."""
        m, n = like.shape[-2:]
        return _prolong2(zc, m, n, w, self.periodic)

    def dense(self, Ainv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """A dense inverse of the whole grid's operator applied to r."""
        return (Ainv @ r.reshape(-1)).reshape(r.shape)


def _prolong2(zc: torch.Tensor, m: int, n: int, w: float,
              periodic: bool) -> torch.Tensor:
    """Cell-centered factor-2 prolongation of (..., mc, nc) to (..., m, n)
    with neighbour weight w (0 = piecewise constant, 1/4 = bilinear);
    meridional edges clamp, zonal edges wrap when periodic."""
    mc, nc = zc.shape[-2], zc.shape[-1]
    zmm = torch.cat([zc[..., :1, :], zc[..., :-1, :]], dim=-2)
    zmp = torch.cat([zc[..., 1:, :], zc[..., -1:, :]], dim=-2)
    z = torch.stack([(1.0 - w) * zc + w * zmm, (1.0 - w) * zc + w * zmp],
                    dim=-2)
    z = z.reshape(z.shape[:-3] + (2 * mc, nc))
    if periodic:
        znm = torch.roll(z, 1, dims=-1)
        znp_ = torch.roll(z, -1, dims=-1)
    else:
        znm = torch.cat([z[..., :1], z[..., :-1]], dim=-1)
        znp_ = torch.cat([z[..., 1:], z[..., -1:]], dim=-1)
    z = torch.stack([(1.0 - w) * z + w * znm, (1.0 - w) * z + w * znp_],
                    dim=-1)
    z = z.reshape(z.shape[:-3] + (2 * mc, 2 * nc))
    return z[..., :m, :n]


def build(An: torch.Tensor, *, periodic: bool, min_cols: int = 64,
          max_levels: int = 10, damping: float = 0.9,
          xline: bool = True, prolong_w: float = 0.25,
          grid=None) -> MGPrec:
    """Build the multigrid hierarchy for one (27, nv, nv, l, m, n)
    stencil sub-block; xline adds the zonal line solve to the smoother.
    With prolong_w > 0 the cycle is nonsymmetric (restriction stays
    sum-aggregation): fine for FGMRES and IDR, not for CG.  grid holds
    the finest level (An is its part of the block; :class:`Whole` by
    default); the coarser levels are whole."""
    g = grid if grid is not None else Whole(periodic)
    levels = []
    cur = An
    while True:
        binv, dummy = _column_inv(cur)
        xinv, xdummy = g.xline_inv(cur) if xline else (None, None)
        levels.append(MGLevel(An=cur, binv=binv, dummy=dummy,
                              xinv=xinv, xdummy=xdummy))
        m, n = g.shape(cur)
        if m * n <= min_cols or len(levels) >= max_levels \
                or m < 4 or n < 4:
            break
        cur = g.coarsen(cur)
        g = Whole(periodic)
    return MGPrec(levels=tuple(levels),
                  coarse_inv=_shifted_dense_inv(
                      _stencil_to_dense(g.whole(cur), periodic)),
                  damping=damping, pw=prolong_w)


def _smooth(lev: MGLevel, z, r, *, periodic, damping, nsweep=1, grid=None):
    """Damped alternating-line Jacobi sweeps: a vertical (column) solve
    followed by a zonal (x-line) solve when built."""
    g = grid if grid is not None else Whole(periodic)
    nv, l, m, n = r.shape
    for _ in range(nsweep):
        res = r - g.st(lev.An, z)
        rc = to_columns(res).masked_fill(lev.dummy, 0.0)
        dz = torch.bmm(lev.binv, rc.unsqueeze(-1)).squeeze(-1)
        z = z + damping * from_columns(dz, nv, l, m, n)
        if lev.xinv is not None:
            res = r - g.st(lev.An, z)
            z = z + damping * g.xline(lev.xinv, lev.xdummy, res)
    return z


def _restrict(res: torch.Tensor) -> torch.Tensor:
    """Sum over 2x2 aggregates of (..., m, n), odd dims zero-padded."""
    m, n = res.shape[-2:]
    res = _pad_hv(res, m % 2, n % 2)
    mc, nc = (m + m % 2) // 2, (n + n % 2) // 2
    return res.reshape(res.shape[:-2] + (mc, 2, nc, 2)).sum(dim=(-3, -1))


def _vcycle(prec: MGPrec, k: int, r, *, periodic, grid=None):
    """One V-cycle from level k; grid holds level k (whole by
    default)."""
    g = grid if grid is not None else Whole(periodic)
    lev = prec.levels[k]
    if len(prec.levels) == 1:
        # degenerate hierarchy: the dense factor is the finest level
        return g.dense(prec.coarse_inv, r)
    z = _smooth(lev, torch.zeros_like(r), r, periodic=periodic,
                damping=prec.damping, grid=g)
    if k == len(prec.levels) - 1:
        return z
    rc = g.restrict(r - g.st(lev.An, z))
    if k + 1 == len(prec.levels) - 1:
        zc = (prec.coarse_inv @ rc.reshape(-1)).reshape(rc.shape)
        # one smoothing pass washes out the gauge of the shift
        zc = _smooth(prec.levels[k + 1], zc, rc, periodic=periodic,
                     damping=prec.damping)
    else:
        zc = _vcycle(prec, k + 1, rc, periodic=periodic)
    z = z + g.prolong(zc, r, prec.pw)
    return _smooth(lev, z, r, periodic=periodic, damping=prec.damping,
                   grid=g)


def apply(prec: MGPrec, r: torch.Tensor, *, periodic: bool,
          cycles: int = 1, grid=None) -> torch.Tensor:
    """z ~= A^{-1} r by V-cycles.  r: (nv, l, m, n), on grid's finest
    level (whole by default)."""
    g = grid if grid is not None else Whole(periodic)
    z = _vcycle(prec, 0, r, periodic=periodic, grid=g)
    for _ in range(cycles - 1):
        res = r - g.st(prec.levels[0].An, z)
        z = z + _vcycle(prec, 0, res, periodic=periodic, grid=g)
    return z


# ---------------------------------------------------------------------
# Scalar 2D multigrid over a 25-point (5x5) stencil — the Chat pressure
# Schur complement of the SIMPLE saddle preconditioner.
# ---------------------------------------------------------------------

_OFFS25 = np.array([(di, dj) for dj in range(-2, 3)
                    for di in range(-2, 3)], dtype=np.int64)
_O25_INDEX = {(int(di), int(dj)): q
              for q, (di, dj) in enumerate(_OFFS25)}


def _pad2(f: torch.Tensor, periodic: bool) -> torch.Tensor:
    """(..., m, n) -> (..., m+4, n+4): zero walls in y, wraparound in x
    when periodic (reach up to 2)."""
    n = f.shape[-1]
    fp = F.pad(f, (2, 2, 2, 2))
    if periodic:
        fp = torch.cat([fp[..., n:n + 2], fp[..., 2:n + 2], fp[..., 2:4]],
                       dim=-1)
    return fp


def shift2d(f: torch.Tensor, di: int, dj: int, periodic: bool
            ) -> torch.Tensor:
    """Plane(s) f (..., m, n) evaluated at (j+dj, i+di)."""
    m, n = f.shape[-2:]
    return _pad2(f, periodic)[..., 2 + dj:2 + dj + m, 2 + di:2 + di + n]


def apply25(C: torch.Tensor, x: torch.Tensor, periodic: bool):
    """y(j,i) = sum_q C[q,j,i] * x(j+dj_q, i+di_q), all 25 windows of
    one padded copy at once."""
    m, n = x.shape[-2:]
    # unfold order 5*(dj+2) + (di+2) is the _OFFS25 order
    win = _pad2(x, periodic).unfold(-2, m, 1).unfold(-2, n, 1)
    return (C * win.reshape(*x.shape[:-2], 25, m, n)).sum(dim=-3)


def coarsen25(C: torch.Tensor, *, periodic: bool) -> torch.Tensor:
    """Galerkin PWC coarsening of a (25, m, n) scalar stencil (m, n
    even)."""
    _, m, n = C.shape
    mc, nc = m // 2, n // 2
    Cr = C.reshape(25, mc, 2, nc, 2)
    out = C.new_zeros((25, mc, nc))
    for q, (di, dj) in enumerate(_OFFS25):
        di, dj = int(di), int(dj)
        for a in range(2):
            for b in range(2):
                out[_O25_INDEX[((b + di) >> 1, (a + dj) >> 1)]] += \
                    Cr[q, :, a, :, b]
    return out


def _xline25(C: torch.Tensor, *, periodic: bool, eps=1e-12):
    """Batched inverses of the pentadiagonal (periodic) x-line blocks
    (offsets with dj == 0), per row j."""
    _, m, n = C.shape
    B = C.new_zeros((m, n, n))
    ii = np.arange(n)
    for di in range(-2, 3):
        band = C[_O25_INDEX[(di, 0)]]          # (m, n)
        col = (ii + di) % n if periodic else ii + di
        ok = ((col >= 0) & (col < n)) if not periodic \
            else np.ones_like(col, bool)
        ri = torch.as_tensor(ii[ok], device=C.device)
        ci = torch.as_tensor(col[ok], device=C.device)
        B[:, ri, ci] += band[:, ri]
    dummy = torch.amax(torch.abs(B), dim=2) < eps
    B = B + torch.diag_embed(dummy.to(B.dtype))
    return inv(B), dummy


class MG2DLevel(NamedTuple):
    C: torch.Tensor
    dinv: torch.Tensor       # pointwise inverse diagonal
    dmask: torch.Tensor      # 1.0 on live rows
    xinv: torch.Tensor
    xdummy: torch.Tensor


class MG2DPrec(NamedTuple):
    levels: tuple
    coarse_inv: torch.Tensor
    damping: float
    pw: float


def build2d(C: torch.Tensor, *, periodic: bool, min_cols: int = 64,
            max_levels: int = 10, damping: float = 0.8,
            prolong_w: float = 0.25) -> MG2DPrec:
    levels = []
    cur = C
    while True:
        _, m, n = cur.shape
        d = cur[_O25_INDEX[(0, 0)]]
        scale = torch.clamp(torch.amax(torch.abs(cur), dim=0), min=1e-30)
        live = torch.abs(d) > 1e-12 * scale
        dinv = torch.where(live, 1.0 / torch.where(live, d, 1.0), 0.0)
        xinv, xdummy = _xline25(cur, periodic=periodic)
        levels.append(MG2DLevel(C=cur, dinv=dinv, dmask=live.to(C.dtype),
                                xinv=xinv, xdummy=xdummy))
        if m * n <= min_cols or len(levels) >= max_levels \
                or m < 4 or n < 4:
            break
        cur = coarsen25(_pad_hv(cur, m % 2, n % 2), periodic=periodic)

    # dense coarsest operator: 25-point scatter in (j, i) ordering
    _, m, n = cur.shape
    N = m * n
    A = cur.new_zeros((N, N))
    jj, ii = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    for q, (di, dj) in enumerate(_OFFS25):
        j2, i2 = jj + dj, ii + di
        ok = (j2 >= 0) & (j2 < m)
        if periodic:
            i2 = i2 % n
        else:
            ok &= (i2 >= 0) & (i2 < n)
        rows = torch.as_tensor((jj * n + ii)[ok], device=C.device)
        cols = torch.as_tensor((j2 * n + i2)[ok], device=C.device)
        A.index_put_((rows, cols), cur[q][torch.as_tensor(ok,
                                                          device=C.device)],
                     accumulate=True)
    return MG2DPrec(levels=tuple(levels), coarse_inv=_shifted_dense_inv(A),
                    damping=damping, pw=prolong_w)


def _smooth2d(lev: MG2DLevel, z, r, *, periodic, damping):
    res = r - apply25(lev.C, z, periodic)
    z = z + damping * lev.dmask * lev.dinv * res
    res = r - apply25(lev.C, z, periodic)
    rx = res.masked_fill(lev.xdummy, 0.0)
    return z + damping * torch.bmm(lev.xinv, rx.unsqueeze(-1)).squeeze(-1)


def _vcycle2d(prec: MG2DPrec, k: int, r, *, periodic):
    lev = prec.levels[k]
    m, n = r.shape
    z = _smooth2d(lev, torch.zeros_like(r), r, periodic=periodic,
                  damping=prec.damping)
    if k == len(prec.levels) - 1:
        return z
    rc = _restrict(r - apply25(lev.C, z, periodic))
    if k + 1 == len(prec.levels) - 1:
        zc = (prec.coarse_inv @ rc.reshape(-1)).reshape(rc.shape)
        zc = _smooth2d(prec.levels[k + 1], zc, rc, periodic=periodic,
                       damping=prec.damping)
    else:
        zc = _vcycle2d(prec, k + 1, rc, periodic=periodic)
    z = z + _prolong2(zc, m, n, prec.pw, periodic)
    return _smooth2d(lev, z, r, periodic=periodic, damping=prec.damping)


def apply2d(prec: MG2DPrec, r: torch.Tensor, *, periodic: bool
            ) -> torch.Tensor:
    """z ~= C^{-1} r by one V-cycle.  r: (m, n)."""
    return _vcycle2d(prec, 0, r, periodic=periodic)
