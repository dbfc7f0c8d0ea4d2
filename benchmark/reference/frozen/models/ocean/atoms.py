# Copied from iemic_tpu/models/ocean/atoms.py (numpy-only; importing iemic_tpu would import jax).
"""Linear stencil atoms of the THCM ocean discretization.

Faithful re-derivation of the atom catalogue in the reference
(src/ocean/spf.F90): every linear operator of the primitive equations on
the staggered B-grid is expressed as coefficients on the 27-point
neighborhood.  Atoms here are *static* per (grid, landmask, mixing
flags) and are therefore precomputed in numpy at model setup; the
parameter-dependent combination into the dependency tensor happens in
:mod:`assembly` (jitted).

Conventions: atom arrays have shape (27, l, m, n) = atom[p, k, j, i]
with p = Fortran stencil location - 1 (see ops.stencil).  Fortran index
helpers: yv(j) -> grid.yv[j] (j = 0..m), y(j) -> grid.y_ext[j]
(j = 0..m+1), dfzT(k) -> grid.dfzT[k-1], dfzW(k) -> grid.dfzW[k].
"""

from __future__ import annotations

import numpy as np

from ...grid import Grid

NP = 27


def amh(y: np.ndarray, ih: int) -> np.ndarray:
    """Inhomogeneous (equatorial) mixing profile (spf.F90:792-806)."""
    if ih == 0:
        return np.ones_like(y)
    return 1.0 + 10.0 * np.exp(-5.0 * y * y)


def bmh(y: np.ndarray, ih: int) -> np.ndarray:
    if ih == 0:
        return np.ones_like(y)
    return 1.0 + 10.0 * np.exp(-5.0 * y * y)


def amhy(y: np.ndarray, ih: int) -> np.ndarray:
    if ih == 0:
        return np.zeros_like(y)
    return -100.0 * y * np.exp(-5.0 * y * y)


def bmhy(y: np.ndarray, ih: int) -> np.ndarray:
    if ih == 0:
        return np.zeros_like(y)
    return -100.0 * y * np.exp(-5.0 * y * y)


def _zeros(grid: Grid) -> np.ndarray:
    return np.zeros((NP, grid.l, grid.m, grid.n))


def _set_j(atom: np.ndarray, loc: int, jsl: slice, vals: np.ndarray) -> None:
    """atom[loc-1, :, jsl, :] = vals broadcast over (k, j, i)."""
    atom[loc - 1, :, jsl, :] = vals[None, :, None]


def uderiv(grid: Grid, typ: int, ih: int = 0) -> np.ndarray:
    """u-momentum atoms (spf.F90:13-74): 1 u, 2 u_xx, 3 u_yy, 4 u_zz,
    5 metric/curvature, 6 cross term v_x tan(phi)."""
    atom = _zeros(grid)
    m = grid.m
    yv_j = grid.yv[1:m]            # yv(j), j = 1..m-1
    jsl = slice(0, m - 1)          # 0-based rows j-1
    if typ == 1:
        atom[4] = 1.0
    elif typ == 2:
        c = amh(yv_j, ih) * (1.0 / (np.cos(yv_j) * grid.dx)) ** 2
        _set_j(atom, 2, jsl, c)
        _set_j(atom, 8, jsl, c)
        _set_j(atom, 5, jsl, -2.0 * c)
    elif typ == 3:
        rdy2i = (1.0 / grid.dy) ** 2
        yj = grid.y_ext[1:m]       # y(j), j = 1..m-1
        yj1 = grid.y_ext[2:m + 1]  # y(j+1)
        a4 = rdy2i * bmh(yj, ih) * np.cos(yj) / np.cos(yv_j)
        a6 = rdy2i * bmh(yj1, ih) * np.cos(yj1) / np.cos(yv_j)
        _set_j(atom, 4, jsl, a4)
        _set_j(atom, 6, jsl, a6)
        _set_j(atom, 5, jsl, -(a4 + a6))
    elif typ == 4:
        rdz2i = (1.0 / grid.dz) ** 2
        for k in range(1, grid.l + 1):
            h1 = 1.0 / (grid.dfzT[k - 1] * grid.dfzW[k])
            h2 = 1.0 / (grid.dfzT[k - 1] * grid.dfzW[k - 1])
            atom[13, k - 1] = h2 * rdz2i
            atom[22, k - 1] = h1 * rdz2i
            atom[4, k - 1] = -(h1 + h2) * rdz2i
    elif typ == 5:
        tand2 = 1.0 - np.tan(yv_j) ** 2
        _set_j(atom, 5, jsl,
               bmh(yv_j, ih) * tand2 + np.tan(yv_j) * bmhy(yv_j, ih))
    elif typ == 6:
        c = (bmhy(yv_j, ih)
             - (amh(yv_j, ih) + bmh(yv_j, ih)) * np.tan(yv_j)) \
            / (grid.dx * np.cos(yv_j))
        _set_j(atom, 2, jsl, c)
        _set_j(atom, 8, jsl, -c)
    else:
        raise ValueError(typ)
    return atom


def vderiv(grid: Grid, typ: int, ih: int = 0) -> np.ndarray:
    """v-momentum atoms (spf.F90:76-136)."""
    atom = _zeros(grid)
    m = grid.m
    yv_j = grid.yv[1:m]
    jsl = slice(0, m - 1)
    if typ == 1:
        atom[4] = 1.0
    elif typ == 2:
        c = bmh(yv_j, ih) * (1.0 / (np.cos(yv_j) * grid.dx)) ** 2
        _set_j(atom, 2, jsl, c)
        _set_j(atom, 5, jsl, -2.0 * c)
        _set_j(atom, 8, jsl, c)
    elif typ == 3:
        dy2i = (1.0 / grid.dy) ** 2
        yj = grid.y_ext[1:m]
        yj1 = grid.y_ext[2:m + 1]
        a4 = dy2i * amh(yj, ih) * np.cos(yj) / np.cos(yv_j)
        a6 = dy2i * amh(yj1, ih) * np.cos(yj1) / np.cos(yv_j)
        _set_j(atom, 4, jsl, a4)
        _set_j(atom, 6, jsl, a6)
        _set_j(atom, 5, jsl, -(a4 + a6))
    elif typ == 4:
        # identical to uderiv type 4
        return uderiv(grid, 4, ih)
    elif typ == 5:
        _set_j(atom, 5, jsl,
               bmh(yv_j, ih) - amh(yv_j, ih) * np.tan(yv_j) ** 2
               + bmhy(yv_j, ih) * np.tan(yv_j))
    elif typ == 6:
        val = ((amh(yv_j, ih) + bmh(yv_j, ih)) * np.tan(yv_j)
               - bmhy(yv_j, ih)) / (grid.dx * np.cos(yv_j))
        _set_j(atom, 2, jsl, -val)
        _set_j(atom, 8, jsl, val)
    else:
        raise ValueError(typ)
    return atom


def pderiv(grid: Grid, typ: int) -> np.ndarray:
    """Continuity-equation divergence atoms (spf.F90:138-187):
    1 u_x, 2 v_y, 3 w_z."""
    atom = _zeros(grid)
    m = grid.m
    jfull = slice(0, m)
    yj = grid.y_ext[1:m + 1]         # y(j), j = 1..m
    if typ == 1:
        c = 1.0 / (2.0 * np.cos(yj) * grid.dx)
        _set_j(atom, 2, jfull, -c)
        _set_j(atom, 4, jfull, c)
        _set_j(atom, 1, jfull, -c)
        _set_j(atom, 5, jfull, c)
    elif typ == 2:
        c = 1.0 / (2.0 * np.cos(yj) * grid.dy)
        cvm = np.cos(grid.yv[0:m])       # cos(yv(j-1))
        cvp = np.cos(grid.yv[1:m + 1])   # cos(yv(j))
        _set_j(atom, 4, jfull, -cvm * c)
        _set_j(atom, 2, jfull, cvp * c)
        _set_j(atom, 1, jfull, -cvm * c)
        _set_j(atom, 5, jfull, cvp * c)
    elif typ == 3:
        dzi = 1.0 / grid.dz
        for k in range(1, grid.l + 1):
            atom[4, k - 1] = dzi / grid.dfzT[k - 1]
            atom[13, k - 1] = -dzi / grid.dfzT[k - 1]
    else:
        raise ValueError(typ)
    return atom


def tderiv(grid: Grid, typ: int, landm: np.ndarray) -> np.ndarray:
    """Tracer atoms (spf.F90:189-268): 1/2 surface restoring points,
    3 t_xx, 4 t_yy, 5 t_zz, 6 buoyancy interpolation (tbc),
    7 bottom point.  All column atoms are masked by the *surface*
    landmask value landm(i,j,l) exactly as the reference does.

    landm: (l+2, m+2, n+2) int array incl. dummy layers.
    """
    atom = _zeros(grid)
    m, l = grid.m, grid.l
    # literal (1 - landm(i,j,l)) as in the Fortran
    surf = 1.0 - landm[l, 1:m + 1, 1:grid.n + 1].astype(np.float64)
    yj = grid.y_ext[1:m + 1]
    if typ in (1, 2):
        atom[4, l - 1] = 1.0
    elif typ == 3:
        c = (1.0 / (np.cos(yj) * grid.dx)) ** 2
        val = c[:, None] * surf
        atom[1, :, :, :] = val[None]
        atom[4, :, :, :] = -2.0 * val[None]
        atom[7, :, :, :] = val[None]
    elif typ == 4:
        dy2i = (1.0 / grid.dy) ** 2
        a4 = (dy2i * np.cos(grid.yv[0:m]) / np.cos(yj))[:, None] * surf
        a6 = (dy2i * np.cos(grid.yv[1:m + 1]) / np.cos(yj))[:, None] * surf
        atom[3, :, :, :] = a4[None]
        atom[5, :, :, :] = a6[None]
        atom[4, :, :, :] = -(a4 + a6)[None]
    elif typ == 5:
        dz2i = (1.0 / grid.dz) ** 2
        for k in range(1, l):
            h1 = 1.0 / (grid.dfzT[k - 1] * grid.dfzW[k])
            h2 = 1.0 / (grid.dfzT[k - 1] * grid.dfzW[k - 1])
            atom[13, k - 1] = h2 * dz2i * surf
            atom[22, k - 1] = h1 * dz2i * surf
            atom[4, k - 1] = -(h1 + h2) * dz2i * surf
        h2 = 1.0 / (grid.dfzT[l - 1] * grid.dfzW[l - 1])
        atom[13, l - 1] = h2 * dz2i * surf
        atom[4, l - 1] = -h2 * dz2i * surf
    elif typ == 6:
        atom[22, :, :, :] = surf[None]
        atom[4, :, :, :] = surf[None]
    elif typ == 7:
        atom[4, 0] = 1.0
    else:
        raise ValueError(typ)
    return atom


def coriolis(grid: Grid, typ: int, coriolis_on: int) -> np.ndarray:
    """Coriolis averaging atoms (spf.F90:271-302)."""
    atom = _zeros(grid)
    m = grid.m
    corv = np.sin(grid.yv[1:m]) * coriolis_on
    _set_j(atom, 5, slice(0, m - 1), corv)
    return atom


def gradp(grid: Grid, typ: int) -> np.ndarray:
    """Pressure gradient atoms (spf.F90:305-345)."""
    atom = _zeros(grid)
    m = grid.m
    yv_j = grid.yv[1:m]
    jsl = slice(0, m - 1)
    if typ == 1:
        c = 1.0 / (2.0 * np.cos(yv_j) * grid.dx)
        _set_j(atom, 5, jsl, -c)
        _set_j(atom, 6, jsl, -c)
        _set_j(atom, 8, jsl, c)
        _set_j(atom, 9, jsl, c)
    elif typ == 2:
        dyi = np.full(m - 1, 1.0 / (2.0 * grid.dy))
        _set_j(atom, 5, jsl, -dyi)
        _set_j(atom, 8, jsl, -dyi)
        _set_j(atom, 6, jsl, dyi)
        _set_j(atom, 9, jsl, dyi)
    elif typ == 3:
        dzi = 1.0 / grid.dz
        for k in range(1, grid.l + 1):
            atom[4, k - 1] = -dzi / grid.dfzW[k]
            atom[22, k - 1] = dzi / grid.dfzW[k]
    else:
        raise ValueError(typ)
    return atom
