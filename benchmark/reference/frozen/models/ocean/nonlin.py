"""State-dependent (advective / nonlinear-EOS) stencil atoms (PyTorch).

Port of ``iemic_tpu/models/ocean/nonlin.py``: the reference's nonlinear
atom builders (spf.F90:362-790 ``tnlin``/``wnlin``/``unlin``/``vnlin``)
and the ghost-field extraction ``usol`` (usrc.F90:997-1104), with every
Fortran loop bound reproduced by slice assignments on fresh tensors.

Ghost-array layout ([k, j, i], 0-based, Fortran index == array index):
    u, v   : (l+2, m+1, n+1)   Fortran u(0:n, 0:m,   0:l+1)
    w      : (l+1, m+2, n+2)   Fortran w(0:n+1, 0:m+1, 0:l)
    p,t,s  : (l+2, m+2, n+2)   Fortran p(0:n+1, 0:m+1, 0:l+1)
"""

from __future__ import annotations

import numpy as np
import torch

from ...grid import Grid
from ...ops.stencil import UU, VV, WW, PP, TT, SS, LAND

NP = 27


def _t(a, ref: torch.Tensor) -> torch.Tensor:
    """numpy constant -> tensor on ref's device, in ref's dtype."""
    return torch.as_tensor(np.asarray(a), dtype=ref.dtype,
                           device=ref.device)


def velocity_keep(landm: np.ndarray, l: int, m: int, n: int) -> np.ndarray:
    """(l, m+1, n+1) bool: the velocity points ``usol`` keeps, those with
    no LAND among the four cells around them (usrc.F90:1087-1102); cells
    outside the grid count as water."""
    Lint = (landm[1:l + 1, 1:m + 1, 1:n + 1] == LAND)
    Lpad = np.zeros((l, m + 2, n + 2), dtype=bool)
    Lpad[:, 1:m + 1, 1:n + 1] = Lint
    zero = (Lpad[:, 0:m + 1, 0:n + 1] | Lpad[:, 1:m + 2, 0:n + 1]
            | Lpad[:, 0:m + 1, 1:n + 2] | Lpad[:, 1:m + 2, 1:n + 2])
    return ~zero


def usol(x: torch.Tensor, landm: np.ndarray, periodic: bool,
         grid: Grid, keep: np.ndarray | None = None) -> tuple:
    """Extract ghosted u,v,w,p,t,s fields from state (usrc.F90:997-1104).
    keep is ``velocity_keep`` of x's grid, computed from landm where not
    given."""
    nun, l, m, n = x.shape
    kw = dict(dtype=x.dtype, device=x.device)
    U = torch.zeros((l + 2, m + 1, n + 1), **kw)
    V = torch.zeros((l + 2, m + 1, n + 1), **kw)
    W = torch.zeros((l + 1, m + 2, n + 2), **kw)
    P = torch.zeros((l + 2, m + 2, n + 2), **kw)
    T = torch.zeros((l + 2, m + 2, n + 2), **kw)
    S = torch.zeros((l + 2, m + 2, n + 2), **kw)

    U[1:l + 1, 1:, 1:] = x[UU]
    V[1:l + 1, 1:, 1:] = x[VV]
    W[1:l + 1, 1:m + 1, 1:n + 1] = x[WW]
    P[1:l + 1, 1:m + 1, 1:n + 1] = x[PP]
    T[1:l + 1, 1:m + 1, 1:n + 1] = x[TT]
    S[1:l + 1, 1:m + 1, 1:n + 1] = x[SS]

    ksl, jsl, isl = slice(1, l + 1), slice(1, m + 1), slice(1, n + 1)

    # x-direction ghosts; the U/V periodic copy happens at the end, from
    # the wall-zeroed and land-masked columns (see the JAX module)
    if periodic:
        for F in (W, P, T, S):
            F[ksl, jsl, n + 1] = F[ksl, jsl, 1]
            F[ksl, jsl, 0] = F[ksl, jsl, n]
    else:
        for F in (U, V):
            F[ksl, jsl, 0] = 0.0
            F[ksl, jsl, n] = 0.0
        P[ksl, jsl, 0] = 0.0
        P[ksl, jsl, n + 1] = 0.0
        for F in (T, S):
            F[ksl, jsl, 0] = F[ksl, jsl, 1]
            F[ksl, jsl, n + 1] = F[ksl, jsl, n]

    # y-direction ghosts
    for F in (U, V):
        F[ksl, 0, isl] = 0.0
        F[ksl, m, isl] = 0.0
    P[ksl, 0, isl] = 0.0
    P[ksl, m + 1, isl] = 0.0
    for F in (T, S):
        F[ksl, 0, isl] = F[ksl, 1, isl]
        F[ksl, m + 1, isl] = F[ksl, m, isl]

    # z-direction ghosts
    for F in (U, V):
        F[0, jsl, isl] = F[1, jsl, isl]
        F[l + 1, jsl, isl] = F[l, jsl, isl]
    W[l, jsl, isl] = 0.0                 # rigid lid: w(surface) = 0
    W[0, jsl, isl] = 0.0
    P[l + 1, jsl, isl] = 0.0
    P[0, jsl, isl] = 0.0
    for F in (T, S):
        F[l + 1, jsl, isl] = F[l, jsl, isl]
        F[0, jsl, isl] = F[1, jsl, isl]

    # land masking of velocity points (usrc.F90:1087-1102)
    if keep is None:
        keep = velocity_keep(landm, l, m, n)
    keep = _t(keep, x)
    U[1:l + 1] *= keep
    V[1:l + 1] *= keep

    if periodic:
        U[:, :, 0] = U[:, :, n]
        V[:, :, 0] = V[:, :, n]

    return U, V, W, P, T, S


def _win(F: torch.Tensor, di: int, dj: int, dk: int,
         l: int, m: int, n: int) -> torch.Tensor:
    """Window F(i+di, j+dj, k+dk) over the interior (1..n, 1..m, 1..l)."""
    return F[1 + dk:1 + dk + l, 1 + dj:1 + dj + m, 1 + di:1 + di + n]


def _zeros_atom(l: int, m: int, n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.zeros((NP, l, m, n), dtype=ref.dtype, device=ref.device)


def tnlin(grid: Grid, typ: int, U, V, W, T, surf) -> torch.Tensor:
    """Tracer advection atoms (spf.F90:362-484).  ``surf`` is the
    (1 - landm(i,j,l)) surface factor, shape (m, n)."""
    l, m, n = grid.l, grid.m, grid.n
    atom = _zeros_atom(l, m, n, T)
    y = grid.y_ext
    yv = grid.yv

    def t_(di, dj, dk):
        return _win(T, di, dj, dk, l, m, n)

    if typ == 1:
        atom[4] = 1.0
    elif typ == 2:   # urTx
        c = _t((1.0 / (4.0 * np.cos(y[1:m + 1]) * grid.dx))[None, :, None],
               T) * surf
        t0, tm, tp = t_(0, 0, 0), t_(-1, 0, 0), t_(1, 0, 0)
        atom[1] = -(t0 + tm) * c
        atom[3] = (tp + t0) * c
        atom[0] = -(t0 + tm) * c
        atom[4] = (tp + t0) * c
    elif typ == 3:   # Utrx
        c = _t((1.0 / (4.0 * np.cos(y[1:m + 1]) * grid.dx))[None, :, None],
               T) * surf
        a2 = -(U[1:l + 1, 1:m + 1, 0:n] + U[1:l + 1, 0:m, 0:n]) * c
        a8 = (U[1:l + 1, 1:m + 1, 1:n + 1] + U[1:l + 1, 0:m, 1:n + 1]) * c
        atom[1] = a2
        atom[7] = a8
        atom[4] = a2 + a8
    elif typ == 4:   # vrTy
        c = _t((1.0 / (4.0 * np.cos(y[1:m + 1]) * grid.dy))[None, :, None],
               T) * surf
        cvm = _t(np.cos(yv[0:m])[None, :, None], T)
        cvp = _t(np.cos(yv[1:m + 1])[None, :, None], T)
        t0, tjm, tjp = t_(0, 0, 0), t_(0, -1, 0), t_(0, 1, 0)
        a4 = -c * (t0 + tjm) * cvm
        a5 = c * (tjp + t0) * cvp
        atom[3] = a4
        atom[0] = a4
        atom[4] = a5
        atom[1] = a5
    elif typ == 5:   # Vtry
        c = _t((1.0 / (4.0 * np.cos(y[1:m + 1]) * grid.dy))[None, :, None],
               T) * surf
        cvm = _t(np.cos(yv[0:m])[None, :, None], T)
        cvp = _t(np.cos(yv[1:m + 1])[None, :, None], T)
        a4 = -(V[1:l + 1, 0:m, 1:n + 1] + V[1:l + 1, 0:m, 0:n]) * c * cvm
        a6 = (V[1:l + 1, 1:m + 1, 1:n + 1] + V[1:l + 1, 1:m + 1, 0:n]) \
            * c * cvp
        atom[3] = a4
        atom[5] = a6
        atom[4] = a4 + a6
    elif typ == 6:   # wrTz
        tdzi = 1.0 / (2.0 * grid.dz)
        dfzT = _t(grid.dfzT[:, None, None], T)
        t0, tkm, tkp = t_(0, 0, 0), t_(0, 0, -1), t_(0, 0, 1)
        atom[13] = -tdzi * surf * (t0 + tkm) / dfzT
        a5 = tdzi * surf * (tkp + t0) / dfzT
        atom[4, :l - 1] = a5[:l - 1]          # k = l: atom(5) = 0
    elif typ == 7:   # Wtrz
        tdzi = 1.0 / (2.0 * grid.dz)
        dfzT = _t(grid.dfzT[:, None, None], T)
        a14 = -_win(W, 0, 0, -1, l, m, n) * surf * tdzi / dfzT
        a23 = _win(W, 0, 0, 0, l, m, n) * surf * tdzi / dfzT
        atom[13] = a14
        atom[22] = a23
        atom[4] = a14 + a23
    else:
        raise ValueError(typ)
    return atom


def wnlin(grid: Grid, typ: int, T) -> torch.Tensor:
    """Nonlinear-EOS buoyancy atoms for the w-equation (spf.F90:486-542);
    cases 1/3 for the Jacobian, 2/4 for the RHS."""
    l, m, n = grid.l, grid.m, grid.n
    atom = _zeros_atom(l, m, n, T)
    t0 = _win(T, 0, 0, 0, l, m, n)[:l - 1]
    tkp = _win(T, 0, 0, 1, l, m, n)[:l - 1]
    if typ == 1:
        val = (t0 + tkp) / 2.0
        atom[22, :l - 1] = val
        atom[4, :l - 1] = val
    elif typ == 2:
        atom[22, :l - 1] = tkp / 4.0
        atom[4, :l - 1] = (t0 + 2.0 * tkp) / 4.0
    elif typ == 3:
        val = 0.375 * (t0 + tkp) ** 2
        atom[4, :l - 1] = val
        atom[22, :l - 1] = val
    elif typ == 4:
        atom[4, :l - 1] = 0.125 * (t0 * t0 + 3.0 * tkp * t0
                                   + 3.0 * tkp * tkp)
        atom[22, :l - 1] = 0.125 * tkp * tkp
    else:
        raise ValueError(typ)
    return atom


def _metrics(grid: Grid, ref: torch.Tensor):
    m = grid.m
    yv = grid.yv
    cyv = _t((1.0 / (2.0 * np.cos(yv[1:m + 1]) * grid.dx))[None, :, None],
             ref)
    cyv_dy = _t((1.0 / (2.0 * np.cos(yv[1:m + 1]) * grid.dy))
                [None, :, None], ref)
    tanr = _t(np.tan(yv[1:m + 1])[None, :, None], ref)
    tdzi = _t((1.0 / (8.0 * grid.dfzT * grid.dz))[:, None, None], ref)
    cvm = _t(np.cos(yv[0:m])[None, :, None], ref)
    cvp2 = _t(np.cos(yv[2:m + 1])[None, :, None], ref)
    return cyv, cyv_dy, tanr, tdzi, cvm, cvp2


def _ywin_atoms(atom, Fjm, Fjp, cvm, cvp2, cyv_dy, m, fac=1.0):
    """The meridional pair shared by uvy1/Urvy1/vvry/Vrvy."""
    atom[3, :, 1:m, :] = (-fac * Fjm * cvm * cyv_dy)[:, 1:m, :]
    atom[5, :, 0:m - 1, :] = fac * Fjp * cvp2 * cyv_dy[:, 0:m - 1, :]


def _wz4(W, l, m, n, xedge=None):
    w4 = (_win(W, 0, 0, 0, l, m, n) + _win(W, 0, 1, 0, l, m, n)
          + _win(W, 1, 0, 0, l, m, n) + _win(W, 1, 1, 0, l, m, n))
    w4m = (_win(W, 0, 0, -1, l, m, n) + _win(W, 0, 1, -1, l, m, n)
           + _win(W, 1, 0, -1, l, m, n) + _win(W, 1, 1, -1, l, m, n))
    if xedge is not None:
        # usol copies the periodic x-ghosts before the rigid lid, so the
        # whole grid's last column reads its east neighbour's top-layer w
        # where a column inside the window reads w = 0
        _, last, wtop = xedge
        east = torch.roll(wtop, -1, dims=-1)
        north = torch.cat([east[1:], torch.zeros_like(east[:1])])
        w4[l - 1, :, last] += (east + north)[:, last]
    return w4, w4m


def _x_bounds(atom, xedge) -> None:
    """The zonal pair's loop bounds (i < n east, i > 1 west) where x's
    grid is a window of a periodic grid.  xedge is (first, last, wtop):
    the window's columns that are the grid's first and its last (bool),
    and the state's top-layer w on the window."""
    if xedge is not None:
        first, last, _ = xedge
        atom[7, ..., last] = 0.0
        atom[1, ..., first] = 0.0


def unlin(grid: Grid, typ: int, U, V, W, xedge=None) -> torch.Tensor:
    """u-momentum advection atoms (spf.F90:544-665); xedge as in
    ``_x_bounds``."""
    l, m, n = grid.l, grid.m, grid.n
    atom = _zeros_atom(l, m, n, U)
    cyv, cyv_dy, tanr, tdzi, cvm, cvp2 = _metrics(grid, U)

    if typ in (1, 2):     # uux / Urux
        fac = 1.0 if typ == 1 else 2.0
        atom[7, :, :, 0:n - 1] = fac * U[1:l + 1, 1:m + 1, 2:n + 1] * cyv
        atom[1, :, :, 1:n] = -fac * U[1:l + 1, 1:m + 1, 1:n] * cyv
        _x_bounds(atom, xedge)
    elif typ == 3:   # uvy1
        _ywin_atoms(atom, V[1:l + 1, 0:m, 1:n + 1],
                    V[1:l + 1, 2:m + 1, 1:n + 1], cvm, cvp2, cyv_dy, m)
    elif typ == 4:   # Urvy1
        _ywin_atoms(atom, U[1:l + 1, 0:m, 1:n + 1],
                    U[1:l + 1, 2:m + 1, 1:n + 1], cvm, cvp2, cyv_dy, m)
    elif typ == 5:   # uwz
        w4, w4m = _wz4(W, l, m, n, xedge)
        a23 = w4 * tdzi
        a14 = -w4m * tdzi
        atom[22] = a23
        atom[13] = a14
        atom[4] = a14 + a23
    elif typ == 6:   # Urwz
        u0 = U[1:l + 1, 1:m + 1, 1:n + 1]
        up = (u0 + U[2:l + 2, 1:m + 1, 1:n + 1]) * tdzi
        um = -(u0 + U[0:l, 1:m + 1, 1:n + 1]) * tdzi
        for loc in (5, 6, 8, 9):
            atom[loc - 1] = up
        for loc in (14, 15, 17, 18):
            atom[loc - 1] = um
    elif typ == 7:   # uvy2
        atom[4] = V[1:l + 1, 1:m + 1, 1:n + 1] * tanr
    elif typ == 8:   # Urvy2
        atom[4] = U[1:l + 1, 1:m + 1, 1:n + 1] * tanr
    else:
        raise ValueError(typ)
    return atom


def vnlin(grid: Grid, typ: int, U, V, W, xedge=None) -> torch.Tensor:
    """v-momentum advection atoms (spf.F90:667-790); xedge as in
    ``_x_bounds``."""
    l, m, n = grid.l, grid.m, grid.n
    atom = _zeros_atom(l, m, n, U)
    cyv, cyv_dy, tanr, tdzi, cvm, cvp2 = _metrics(grid, U)

    if typ == 1:     # uvx
        atom[7, :, :, 0:n - 1] = U[1:l + 1, 1:m + 1, 2:n + 1] * cyv
        atom[1, :, :, 1:n] = -U[1:l + 1, 1:m + 1, 1:n] * cyv
        _x_bounds(atom, xedge)
    elif typ == 2:   # uVrx
        atom[7, :, :, 0:n - 1] = V[1:l + 1, 1:m + 1, 2:n + 1] * cyv
        atom[1, :, :, 1:n] = -V[1:l + 1, 1:m + 1, 1:n] * cyv
        _x_bounds(atom, xedge)
    elif typ in (3, 4):   # vvry / Vrvy
        _ywin_atoms(atom, V[1:l + 1, 0:m, 1:n + 1],
                    V[1:l + 1, 2:m + 1, 1:n + 1], cvm, cvp2, cyv_dy, m,
                    fac=1.0 if typ == 3 else 2.0)
    elif typ == 5:   # vwz — same window pattern as unlin uwz
        return unlin(grid, 5, U, V, W, xedge)
    elif typ == 6:   # Vrwz
        v0 = V[1:l + 1, 1:m + 1, 1:n + 1]
        vp = (v0 + V[2:l + 2, 1:m + 1, 1:n + 1]) * tdzi
        vm = -(v0 + V[0:l, 1:m + 1, 1:n + 1]) * tdzi
        for loc in (5, 6, 8, 9):
            atom[loc - 1] = vp
        for loc in (14, 15, 17, 18):
            atom[loc - 1] = vm
    elif typ == 7:   # wvrz (reference uses u here)
        atom[4] = U[1:l + 1, 1:m + 1, 1:n + 1] * tanr
    elif typ == 8:   # Urt2
        atom[4] = 2.0 * U[1:l + 1, 1:m + 1, 1:n + 1] * tanr
    else:
        raise ValueError(typ)
    return atom
