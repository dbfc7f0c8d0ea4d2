"""Assembly of the ocean dependency tensor, mass matrix and forcing
(PyTorch).

Port of ``iemic_tpu/models/ocean/assembly.py``:
  * ``lin``        — parameter-weighted combination of linear atoms into
                     the dependency tensor Al (usrc.F90:588-772)
  * ``nlin``       — nonlinear additions (usrc.F90:775-995)
  * ``boundaries`` — land/wall/surface/bottom boundary handling
                     (boundary.F90:2-393), same sequential update order,
                     applied in place to a copy of the tensor
  * ``fillcolB``   — diagonal mass matrix (assemble.F90:18-54)
  * ``forcing``    — forcing vector (forcing.F90:4-218) incl. the
                     area-integral flux corrections (THCM.C:2704-2737)
  * ``intcond_coeff`` — salinity integral-condition row coefficients
                     (thcm_utils.F90:285-312)

Every function works on the device and dtype of its tensor arguments;
``par`` (30 entries, see constants.py) is a tensor.  The coupled
(atmosphere / sea-ice) branches take their coefficients from
``CouplingCoefs`` and their fields from ``ForcingFields``; a field may
carry a forward-mode tangent (``torch.autograd.forward_ad``), which the
coupled model's coupling blocks push through ``lin`` and ``forcing``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...grid import Grid
from ...ops.stencil import UU, VV, WW, PP, TT, SS, OCEAN, LAND, offsets
from . import atoms as at
from . import nonlin
from . import constants as c



class CouplingCoefs(NamedTuple):
    """Coefficients fed in by the atmosphere / sea-ice models
    (reference usrc.F90:237-333 set_atmos_parameters /
    set_seaice_parameters and m_atm module state)."""
    Ooa: float = 0.0
    lvsc: float = 0.0
    eta: float = 0.0
    qdim: float = 0.01
    dqso: float = 0.0
    nus: float = 0.0
    zeta: float = 0.0   # sea-ice zeta
    a0: float = 0.0     # freezing-temperature S sensitivity
    Lf: float = 1.0     # latent heat of fusion (avoid div-by-0)
    eo0: float = 0.0
    albe0: float = 0.0
    albed: float = 0.0
    q0: float = 0.0
    qvar: float = 1.0


class LinearAtoms(NamedTuple):
    """Static precomputed linear atoms, tensors of shape (27, l, m, n)."""
    uxx: torch.Tensor
    uyy: torch.Tensor
    uzz: torch.Tensor
    ucsi: torch.Tensor
    uxs: torch.Tensor   # vderiv(6) in the u-equation cross term
    vxs: torch.Tensor   # uderiv(6)
    fu: torch.Tensor
    fv: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vxx: torch.Tensor
    vyy: torch.Tensor
    vzz: torch.Tensor
    vcsi: torch.Tensor
    pux: torch.Tensor   # pderiv(1)
    pvy: torch.Tensor   # pderiv(2)
    pwz: torch.Tensor   # pderiv(3)
    tc: torch.Tensor    # tderiv(1)
    sc: torch.Tensor    # tderiv(2)
    txx: torch.Tensor
    tyy: torch.Tensor
    tzz: torch.Tensor
    tbc: torch.Tensor   # tderiv(6)
    tcb: torch.Tensor   # tderiv(7)


def build_linear_atoms(grid: Grid, landm: np.ndarray, *, device,
                       dtype=torch.float64, ih: int = 0,
                       coriolis_on: int = 1) -> LinearAtoms:
    """Precompute all state-independent atoms (once per landmask) on
    ``device``."""
    raw = dict(
        uxx=at.uderiv(grid, 2, ih), uyy=at.uderiv(grid, 3, ih),
        uzz=at.uderiv(grid, 4, ih), ucsi=at.uderiv(grid, 5, ih),
        vxs=at.uderiv(grid, 6, ih), uxs=at.vderiv(grid, 6, ih),
        fu=at.coriolis(grid, 2, coriolis_on),
        fv=at.coriolis(grid, 1, coriolis_on),
        px=at.gradp(grid, 1), py=at.gradp(grid, 2), pz=at.gradp(grid, 3),
        vxx=at.vderiv(grid, 2, ih), vyy=at.vderiv(grid, 3, ih),
        vzz=at.vderiv(grid, 4, ih), vcsi=at.vderiv(grid, 5, ih),
        pux=at.pderiv(grid, 1), pvy=at.pderiv(grid, 2),
        pwz=at.pderiv(grid, 3),
        tc=at.tderiv(grid, 1, landm), sc=at.tderiv(grid, 2, landm),
        txx=at.tderiv(grid, 3, landm), tyy=at.tderiv(grid, 4, landm),
        tzz=at.tderiv(grid, 5, landm), tbc=at.tderiv(grid, 6, landm),
        tcb=at.tderiv(grid, 7, landm))
    return LinearAtoms(**{k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                             device=device)
                          for k, v in raw.items()})


def masksi_atom(grid: Grid, msi: torch.Tensor) -> torch.Tensor:
    """Sea-ice mask atom (spf.F90:347-359): diagonal at the surface."""
    atom = torch.zeros((27, grid.l, grid.m, grid.n), dtype=msi.dtype,
                       device=msi.device)
    atom[4, grid.l - 1] = msi
    return atom


def lin(A: LinearAtoms, par: torch.Tensor, grid: Grid, *,
        tres: int, sres: int, coupled_T: int, coupled_S: int,
        cpl: CouplingCoefs = CouplingCoefs(),
        msi: torch.Tensor | None = None,
        QTnd: float = 0.0, QSnd: float = 0.0) -> torch.Tensor:
    """Combine linear atoms into Al (usrc.F90:588-772); the coupled T and
    S rows take the sea-ice mask msi (m, n) and the coefficients cpl."""
    EV = par[c.EK_V]
    EH = par[c.EK_H]
    ph = (1.0 - par[c.MIXP]) * par[c.PE_H]
    pv = par[c.PE_V]
    lam = par[c.LAMB]
    xes = par[c.NLES]
    bi = par[c.BIOT]
    Ra = par[c.RAYL]

    l, m, n = grid.l, grid.m, grid.n
    Al = torch.zeros((27, 6, 6, l, m, n), dtype=par.dtype,
                     device=par.device)
    Al[:, UU, UU] = -EH * (A.uxx + A.uyy + A.ucsi) - EV * A.uzz
    Al[:, UU, VV] = -A.fv - EH * A.vxs
    Al[:, UU, PP] = A.px
    Al[:, VV, UU] = A.fu - EH * A.uxs
    Al[:, VV, VV] = -EH * (A.vxx + A.vyy + A.vcsi) - EV * A.vzz
    Al[:, VV, PP] = A.py
    # w-equation (hydrostatic balance, linear EOS rho = lam*S - T)
    Al[:, WW, PP] = A.pz
    Al[:, WW, TT] = -Ra * (1.0 + xes * c.ALPT1) * A.tbc / 2.0
    Al[:, WW, SS] = lam * Ra * A.tbc / 2.0
    # p-equation (continuity)
    Al[:, PP, UU] = A.pux
    Al[:, PP, VV] = A.pvy
    Al[:, PP, WW] = A.pwz
    if coupled_T == 1 or coupled_S == 1:
        if msi is None:
            msi = torch.zeros((m, n), dtype=par.dtype, device=par.device)
        mc = masksi_atom(grid, msi)
    if coupled_T == 1:
        dedt = cpl.lvsc * cpl.eta * cpl.qdim * (c.DELTAT / cpl.qdim) \
            * cpl.dqso
        Al[:, TT, TT] = (-ph * (A.txx + A.tyy) - pv * A.tzz
                         + cpl.Ooa * A.tc + dedt * A.sc
                         + mc * (QTnd * cpl.zeta * A.tc - cpl.Ooa * A.tc
                                 - dedt * A.sc))
        Al[:, TT, SS] = -QTnd * cpl.zeta * cpl.a0 * mc
    else:
        Al[:, TT, TT] = (-ph * (A.txx + A.tyy) - pv * A.tzz
                         + tres * bi * A.tc)
    if coupled_S == 1:
        dedt = cpl.nus * (c.DELTAT / cpl.qdim) * cpl.dqso
        pQSnd = par[c.COMB] * par[c.SALT] * QSnd
        Al[:, SS, SS] = (-ph * (A.txx + A.tyy) - pv * A.tzz
                         - mc * pQSnd * cpl.zeta * cpl.a0
                         / (c.RHODIM * cpl.Lf))
        QSoa = -dedt * A.sc
        QSos = pQSnd * cpl.zeta / (c.RHODIM * cpl.Lf)
        Al[:, SS, TT] = QSoa + mc * (QSos - QSoa)
    else:
        Al[:, SS, SS] = (-ph * (A.txx + A.tyy) - pv * A.tzz
                         + sres * bi * A.sc)
    return Al


def _surf(landm: np.ndarray, l: int, m: int, n: int,
          ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(
        1.0 - landm[l, 1:m + 1, 1:n + 1].astype(np.float64),
        dtype=ref.dtype, device=ref.device)


def nlin(Al: torch.Tensor, x: torch.Tensor, par: torch.Tensor, grid: Grid,
         landm: np.ndarray, periodic: bool, *, jac: bool,
         keep: np.ndarray | None = None, xedge=None) -> torch.Tensor:
    """Al plus the nonlinear (advective + nonlinear-EOS) atoms.

    jac=False reproduces ``nlin_rhs`` (usrc.F90:775-870): An(x)*x equals
    the full nonlinear term; jac=True reproduces ``nlin_jac``
    (usrc.F90:873-995).  Al is updated in place and returned.  keep is
    passed on to ``nonlin.usol``, xedge to ``nonlin.unlin``/``vnlin``."""
    epsr = par[c.ROSB]
    Ra = par[c.RAYL]
    xes = par[c.NLES]
    l, m, n = grid.l, grid.m, grid.n

    U, V, W, P, T, S = nonlin.usol(x, landm, periodic, grid, keep)
    surf = _surf(landm, l, m, n, x)
    un = lambda t: nonlin.unlin(grid, t, U, V, W, xedge)  # noqa: E731
    vn = lambda t: nonlin.vnlin(grid, t, U, V, W, xedge)  # noqa: E731
    tn = lambda t, F: nonlin.tnlin(grid, t, U, V, W, F, surf)  # noqa: E731
    An = Al

    if not jac:
        An[:, UU, UU] += epsr * (un(1) + un(3) + un(5) + un(7))
        An[:, VV, UU] += epsr * vn(7)
        An[:, VV, VV] += epsr * (vn(1) + vn(3) + vn(5))
        An[:, WW, TT] += (-Ra * xes * c.ALPT2 * nonlin.wnlin(grid, 2, T)
                          + Ra * xes * c.ALPT3 * nonlin.wnlin(grid, 4, T))
        An[:, TT, TT] += tn(3, T) + tn(5, T) + tn(7, T)
        An[:, SS, SS] += tn(3, S) + tn(5, S) + tn(7, S)
    else:
        An[:, UU, UU] += epsr * (un(2) + un(3) + un(5) + un(7))
        An[:, UU, VV] += epsr * (un(4) + un(8))
        An[:, UU, WW] += epsr * un(6)
        An[:, VV, UU] += epsr * (vn(8) + vn(2))
        An[:, VV, VV] += epsr * (vn(1) + vn(4) + vn(5))
        An[:, VV, WW] += epsr * vn(6)
        An[:, WW, TT] += (-Ra * xes * c.ALPT2 * nonlin.wnlin(grid, 1, T)
                          + Ra * xes * c.ALPT3 * nonlin.wnlin(grid, 3, T))
        for var, F in ((TT, T), (SS, S)):
            An[:, var, UU] += tn(2, F)
            An[:, var, VV] += tn(4, F)
            An[:, var, WW] += tn(6, F)
            An[:, var, var] += tn(3, F) + tn(5, F) + tn(7, F)
    return An


# ---------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------

def _nbmask(landm_ext: np.ndarray, di: int, dj: int, dk: int,
            l: int, m: int, n: int, value: int = LAND) -> np.ndarray:
    """(l,m,n) bool: neighbor (i+di, j+dj, k+dk) has landmask == value;
    landm_ext is the mask padded to (l+2, m+3, n+3)."""
    return (landm_ext[1 + dk:1 + dk + l,
                      1 + dj:1 + dj + m,
                      1 + di:1 + di + n] == value)


def _extended(landm: np.ndarray, l: int, m: int, n: int) -> np.ndarray:
    lme = np.full((l + 2, m + 3, n + 3), LAND, dtype=landm.dtype)
    lme[:, :m + 2, :n + 2] = landm
    return lme


def boundary_masks(landm: np.ndarray, l: int, m: int, n: int) -> dict:
    """The (l, m, n) bool masks ``boundaries`` reads from the land mask:
    ``ocean`` (the centre cell is OCEAN), ``LM[p]`` (neighbour p, 1-27,
    is LAND) and the guarded 'extra' neighbours (boundary.F90:64-78).
    Every mask is a property of its own row, so a window of the masks
    gives the boundary treatment of that window of the grid."""
    lme = _extended(landm, l, m, n)

    def nb(di, dj, dk):
        return _nbmask(lme, di, dj, dk, l, m, n)

    offs = offsets()
    # 'extra' neighbours; guards i<n / j<m applied
    i_lt_n = np.broadcast_to(np.arange(n)[None, None, :] < n - 1, (l, m, n))
    j_lt_m = np.broadcast_to(np.arange(m)[None, :, None] < m - 1, (l, m, n))
    return dict(
        ocean=_nbmask(lme, 0, 0, 0, l, m, n, OCEAN),
        LM={p + 1: nb(*offs[p]) for p in range(27)},
        southee=nb(2, -1, 0) & i_lt_n,
        easteast=nb(2, 0, 0) & i_lt_n,
        northee=nb(2, 1, 0) & i_lt_n,
        nnorthee=nb(2, 2, 0) & i_lt_n & j_lt_m,
        nn_j2=nb(0, 2, 0) & j_lt_m)     # nnwest == nnorth == nneast


def boundaries(An: torch.Tensor, landm: np.ndarray, grid: Grid, *,
               linear_part: bool = False,
               masks: dict | None = None) -> torch.Tensor:
    """Apply boundary conditions to (a copy of) the dependency tensor
    (boundary.F90:2-393), preserving the exact sequential update order.

    The map is affine in An: masked copies, sums and zeros, plus entries
    set to constants (identity rows, the weak 1e-10 links).  With
    linear_part=True those entries are set to zero instead, which gives
    the linear part alone: the derivative of the map in the direction
    An.  masks are ``boundary_masks`` of An's grid, computed from landm
    where not given."""
    l, m, n = grid.l, grid.m, grid.n
    one, weak = (0.0, 0.0) if linear_part else (1.0, 1.0e-10)
    An = An.clone()
    if masks is None:
        masks = boundary_masks(landm, l, m, n)
    ocean, LM = masks["ocean"], masks["LM"]
    southee, easteast = masks["southee"], masks["easteast"]
    northee, nnorthee = masks["northee"], masks["nnorthee"]
    nn_j2 = masks["nn_j2"]

    def msk(mask):
        return torch.as_tensor(mask & ocean, device=An.device)

    UV = slice(0, 2)
    TSc = slice(4, 6)
    ALL = slice(None)

    def zero_cols(locs, cols, mask):
        """An(loc, :, cols) = 0 where mask."""
        mk = msk(mask)
        for loc in locs:
            An[loc - 1, :, cols].masked_fill_(mk, 0.0)

    def fold(src, dst, cols, mask):
        """An(dst, :, cols) += An(src, :, cols) where mask."""
        mk = msk(mask)
        An[dst - 1, :, cols] += torch.where(mk, An[src - 1, :, cols], 0.0)

    def dirichlet_row(var, mask):
        """Replace the <var>-equation by var = 0 (identity row) and
        remove the center column of var from all other equations."""
        mk = msk(mask)
        An[:, var, :].masked_fill_(mk, 0.0)
        An[4, :, var].masked_fill_(mk, 0.0)
        An[4, var, var].masked_fill_(mk, one)

    # ---- bottom (loc 14) block (boundary.F90:84-110) ----------------
    b = LM[14]
    fold(10, 1, UV, b & LM[11] & LM[10] & LM[13])
    zero_cols((10,), UV, b)
    fold(11, 2, UV, b & LM[11] & LM[18] & LM[15])
    zero_cols((11,), UV, b)
    fold(13, 4, UV, b & LM[17] & LM[16] & LM[13])
    zero_cols((13,), UV, b)
    fold(14, 5, UV, b & LM[17] & LM[18] & LM[15])
    fold(14, 5, TSc, b)
    zero_cols((14,), ALL, b)

    # ---- standalone below-layer neighbours (boundary.F90:111-134) ---
    for loc in (10, 11, 12, 13, 15, 16, 17, 18):
        zero_cols((loc,), ALL, LM[loc])

    # ---- top (loc 23) block (boundary.F90:135-179) ------------------
    t = LM[23]
    fold(19, 1, UV, t & LM[20] & LM[19] & LM[22])
    zero_cols((19,), UV, t)
    fold(20, 2, UV, t & LM[20] & LM[21] & LM[24])
    zero_cols((20,), UV, t)
    fold(22, 4, UV, t & LM[26] & LM[25] & LM[22])
    zero_cols((22,), UV, t)
    fold(23, 5, UV, t & LM[26] & LM[27] & LM[24])
    fold(23, 5, TSc, t)
    zero_cols((23,), ALL, t)
    # replace w-equation by w = 0 with weak 1e-10 links kept for the
    # preconditioner (boundary.F90:169-177)
    tk = msk(t)
    An[:, WW, :].masked_fill_(tk, 0.0)
    for loc in (4, 5, 7, 8):
        An[loc, :, WW].masked_fill_(tk, weak)
    An[4, WW, WW].masked_fill_(tk, one)

    # ---- standalone above-layer neighbours (boundary.F90:180-205) ---
    for loc in (19, 20, 21, 22, 24, 25, 26, 27):
        zero_cols((loc,), ALL, LM[loc])

    # ---- lateral neighbours -----------------------------------------
    zero_cols((1,), UV, LM[1])                  # southwest (1)
    fold(2, 5, TSc, LM[2])                      # west (2)
    zero_cols((2,), ALL, LM[2])
    zero_cols((1,), UV, LM[2])
    zero_cols((2, 3), UV, LM[3])                # northwest (3) / nnwest
    zero_cols((3,), UV, (~LM[3]) & nn_j2)
    fold(4, 5, TSc, LM[4])                      # south (4)
    zero_cols((4,), ALL, LM[4])
    zero_cols((1,), UV, LM[4])
    no = LM[6]                                  # north (6)
    zero_cols((2,), UV, no)
    nk = msk(no)
    An[1, PP, UV].masked_fill_(nk, 0.0)
    An[4, PP, UV].masked_fill_(nk, 0.0)
    dirichlet_row(VV, no)
    dirichlet_row(UU, no)
    fold(6, 5, TSc, no)
    zero_cols((6,), ALL, no)
    zero_cols((3, 6), UV, (~no) & nn_j2)
    zero_cols((4, 7), UV, LM[7])                # southeast (7) / southee
    zero_cols((7,), UV, (~LM[7]) & southee)
    ea = LM[8]                                  # east (8)
    zero_cols((4,), UV, ea)
    ek = msk(ea)
    An[3, PP, UV].masked_fill_(ek, 0.0)
    An[4, PP, UV].masked_fill_(ek, 0.0)
    dirichlet_row(UU, ea)
    dirichlet_row(VV, ea)
    fold(8, 5, TSc, ea)
    zero_cols((8,), ALL, ea)
    zero_cols((7,), UV, ea)
    zero_cols((7, 8), UV, (~ea) & easteast)
    ne = LM[9]                                  # northeast (9)
    dirichlet_row(UU, ne)
    dirichlet_row(VV, ne)
    zero_cols((7,), UV, ne)
    zero_cols((8, 9), UV, (~ne) & northee)
    zero_cols((9,), UV, (~ne) & (~northee) & nnorthee)
    zero_cols((6, 9), UV, (~ne) & nn_j2)

    # ---- center not OCEAN: identity rows (boundary.F90:381-387) -----
    land_c = torch.as_tensor(~ocean, device=An.device)
    An.masked_fill_(land_c, 0.0)
    for ii in (UU, VV, WW, PP, TT, SS):
        An[4, ii, ii].masked_fill_(land_c, one)
    return An


def boundary_frc_zero(Frc: torch.Tensor, landm: np.ndarray, grid: Grid
                      ) -> torch.Tensor:
    """Zero forcing rows as boundaries() does in the reference: W rows
    where top==LAND, U/V rows where north/east/neast is LAND, everything
    on non-ocean cells."""
    l, m, n = grid.l, grid.m, grid.n
    lme = _extended(landm, l, m, n)
    ocean = _nbmask(lme, 0, 0, 0, l, m, n, OCEAN)
    top = _nbmask(lme, 0, 0, 1, l, m, n) & ocean
    uvzero = ((_nbmask(lme, 0, 1, 0, l, m, n)
               | _nbmask(lme, 1, 0, 0, l, m, n)
               | _nbmask(lme, 1, 1, 0, l, m, n)) & ocean)
    dev = Frc.device
    Frc = Frc.clone()
    Frc[WW].masked_fill_(torch.as_tensor(top, device=dev), 0.0)
    uvz = torch.as_tensor(uvzero, device=dev)
    Frc[UU].masked_fill_(uvz, 0.0)
    Frc[VV].masked_fill_(uvz, 0.0)
    Frc.masked_fill_(torch.as_tensor(~ocean, device=dev), 0.0)
    return Frc


# ---------------------------------------------------------------------
# mass matrix
# ---------------------------------------------------------------------

def fillcolB(par: torch.Tensor, landm: np.ndarray, grid: Grid, *,
             sres: int) -> torch.Tensor:
    """Diagonal of the mass matrix B (assemble.F90:18-54), field layout
    (6, l, m, n), with the Fortran values (-Ro for u,v, -1 for T,S)."""
    l, m, n = grid.l, grid.m, grid.n
    ocean = (landm[1:l + 1, 1:m + 1, 1:n + 1] == OCEAN)
    east_not_land = (landm[1:l + 1, 1:m + 1, 2:n + 2] != LAND)
    north_not_land = (landm[1:l + 1, 2:m + 2, 1:n + 1] != LAND)

    def t(mask):
        return torch.as_tensor(mask, device=par.device)

    B = torch.zeros((6, l, m, n), dtype=par.dtype, device=par.device)
    Ro = par[c.ROSB]
    B[UU] = torch.where(t(ocean & east_not_land), -Ro, 0.0)
    B[VV] = torch.where(t(ocean & north_not_land), -Ro, 0.0)
    B[TT] = torch.where(t(ocean), -1.0, 0.0)
    B[SS] = torch.where(t(ocean), -1.0, 0.0)
    return B


# ---------------------------------------------------------------------
# forcing
# ---------------------------------------------------------------------

def wfun(yy: np.ndarray) -> np.ndarray:
    """F. Bryan (1987) analytical zonal wind profile (forcing.F90:489)."""
    ay = np.abs(yy)
    return (0.2 - 0.8 * np.sin(6.0 * ay)
            - 0.5 * (1.0 - np.tanh(10.0 * ay))
            - 0.5 * (1.0 - np.tanh(10.0 * (np.pi / 2.0 - ay))))


def temfun(yy, ymin, ymax, cmpr, forcing_type: int):
    """Idealized temperature profile (forcing.F90:508-518)."""
    if forcing_type == 2:
        return torch.cos(np.pi * (yy - ymin) / (ymax - ymin))
    return torch.cos(np.pi * yy / ymax) + cmpr * torch.sin(np.pi * yy / ymax)


def salfun(yy, ymin, ymax, fper, forcing_type: int):
    """Idealized salinity flux profile (forcing.F90:521-533)."""
    if forcing_type == 2:
        return torch.cos(np.pi * (yy - ymin) / (ymax - ymin))
    if forcing_type == 1:
        return (torch.cos(np.pi * yy / ymax)
                + fper * yy / ymax) / torch.cos(yy)
    return torch.cos(np.pi * yy / ymax) + fper * yy / ymax


def qint(field: torch.Tensor, grid: Grid, landm: np.ndarray):
    """Area-weighted surface integral correction (THCM.C:2704-2737):
    cor = sum(f cos(y) (1-landm_surf)) / sum(cos(y) (1-landm_surf))."""
    l, m, n = grid.l, grid.m, grid.n
    w = np.cos(grid.y_ext[1:m + 1])[:, None] \
        * (1.0 - landm[l, 1:m + 1, 1:n + 1])
    w = torch.as_tensor(np.broadcast_to(w, (m, n)).copy(),
                        dtype=field.dtype, device=field.device)
    return torch.sum(field * w) / torch.sum(w)


class ForcingFields(NamedTuple):
    """External 2D/3D forcing fields (reference m_usr allocatables);
    None means zero / the idealized profile generated in forcing()."""
    taux: torch.Tensor | None = None
    tauy: torch.Tensor | None = None
    tatm: torch.Tensor | None = None
    emip: torch.Tensor | None = None
    spert: torch.Tensor | None = None
    adapted_emip: torch.Tensor | None = None
    internal_temp: torch.Tensor | None = None
    internal_salt: torch.Tensor | None = None
    # coupled runs: atmosphere and sea-ice interface fields (m, n)
    suno: torch.Tensor | None = None
    albe: torch.Tensor | None = None
    qatm: torch.Tensor | None = None
    patm: torch.Tensor | None = None
    msi: torch.Tensor | None = None
    qsa: torch.Tensor | None = None
    gsi: torch.Tensor | None = None


def forcing(par: torch.Tensor, grid: Grid, landm: np.ndarray, *,
            tres: int, sres: int, its: int, ite: int, iza: int,
            coupled_T: int, coupled_S: int, forcing_type: int,
            fields: ForcingFields, cpl: CouplingCoefs = CouplingCoefs(),
            QTnd: float = 0.0, QSnd: float = 0.0) -> torch.Tensor:
    """Assemble the forcing vector Frc (forcing.F90:4-218), shape
    (6, l, m, n)."""
    l, m, n = grid.l, grid.m, grid.n
    ymin, ymax = grid.ymin, grid.ymax
    kw = dict(dtype=par.dtype, device=par.device)
    yj = torch.as_tensor(grid.y_ext[1:m + 1], **kw)[:, None]     # (m, 1)
    surf_mask = _surf(landm, l, m, n, par)

    def zeros2():
        return torch.zeros((m, n), **kw)

    Frc = torch.zeros((6, l, m, n), **kw)

    # -- wind ---------------------------------------------------------
    sigma = par[c.COMB] * par[c.WIND] * par[c.AL_T]
    if iza == 2:
        taux = torch.as_tensor(wfun(grid.yv[1:m + 1]), **kw)[:, None] \
            .expand(m, n)
        tauy = zeros2()
    else:
        taux, tauy = fields.taux, fields.tauy
    # rows j = 1..m-1 only (forcing.F90:45-50)
    Frc[UU, l - 1, 0:m - 1, :] = sigma * taux[0:m - 1]
    Frc[VV, l - 1, 0:m - 1, :] = sigma * tauy[0:m - 1]

    def field(name):
        v = getattr(fields, name)
        return v if v is not None else zeros2()

    # -- temperature --------------------------------------------------
    etabi = par[c.COMB] * par[c.TEMP] * (1 - tres + tres * par[c.BIOT])
    temcor = 0.0
    if ite == 1 and coupled_T == 0:
        tatm = temfun(yj, ymin, ymax, par[c.CMPR], forcing_type) \
            .expand(m, n)
        if tres == 0:
            temcor = qint(tatm, grid, landm)
    else:
        tatm = field("tatm")
    if coupled_T == 1:
        msi = field("msi")
        QToa = (par[c.COMB] * par[c.SUNP] * fields.suno
                * (1.0 - cpl.albe0 - cpl.albed * field("albe"))
                + cpl.Ooa * tatm
                + cpl.lvsc * cpl.eta * cpl.qdim * field("qatm")
                - cpl.lvsc * cpl.eo0)
        QTos = QTnd * cpl.zeta * (cpl.a0 * c.S0 - c.T0)
        Frc[TT, l - 1] = (QToa + msi * (QTos - QToa)) * surf_mask
    else:
        Frc[TT, l - 1] = etabi * (tatm - temcor)

    # -- salinity -----------------------------------------------------
    if coupled_S == 1:
        gamma = par[c.COMB] * par[c.SALT]
    else:
        gamma = par[c.COMB] * par[c.SALT] * (1 - sres + sres * par[c.BIOT])
    salcor = 0.0
    if its == 1:
        emip = salfun(yj, ymin, ymax, par[c.FPER], forcing_type) \
            .expand(m, n) * surf_mask
        if sres == 0 and coupled_S == 0:
            salcor = qint(emip, grid, landm)
    else:
        emip = field("emip")

    spert = field("spert")
    adapted_emip = field("adapted_emip")
    if sres == 0 and coupled_S == 0:
        adapted_salcor = qint(adapted_emip, grid, landm)
        spertcor = qint(spert, grid, landm)
    else:
        adapted_salcor = 0.0
        spertcor = 0.0
    if coupled_S == 1:
        pQSnd = par[c.COMB] * par[c.SALT] * QSnd
        msi = field("msi")
        QSoa = pQSnd * (cpl.eo0 - cpl.eta * cpl.qdim * field("qatm")
                        - field("patm"))
        QSos = pQSnd * (cpl.zeta * (cpl.a0 * c.S0 - c.T0)
                        - cpl.qvar * field("qsa") - cpl.q0) \
            / (c.RHODIM * cpl.Lf)
        Frc[SS, l - 1] = (QSoa + msi * (QSos - QSoa) - field("gsi")) \
            * surf_mask
    else:
        Frc[SS, l - 1] = (gamma * (1.0 - par[c.HMTP]) * (emip - salcor)
                          + gamma * par[c.HMTP]
                          * (adapted_emip - adapted_salcor)
                          + par[c.SPER] * (1 - sres + sres * par[c.BIOT])
                          * (spert - spertcor))

    # -- internal (z-direction) forcing -------------------------------
    if fields.internal_temp is not None:
        it3 = fields.internal_temp   # (l, m, n)
        is3 = fields.internal_salt
        interior = torch.as_tensor(
            1.0 - landm[1:l + 1, 1:m + 1, 1:n + 1].astype(np.float64), **kw)
        Frc[WW, 0:l - 1] = -par[c.COMB] * interior[:l - 1] * par[c.RAYL] * (
            par[c.LAMB] * (is3[0:l - 1] + is3[1:l]) / 2.0
            - (it3[0:l - 1] + it3[1:l]) / 2.0)
    return Frc


def intcond_coeff(grid: Grid, landm: np.ndarray) -> np.ndarray:
    """Salinity integral-condition coefficients (thcm_utils.F90:285-312):
    cos(y(j)) * dfzT(k) on SS rows of ocean cells, field layout (numpy)."""
    l, m, n = grid.l, grid.m, grid.n
    ocean = (landm[1:l + 1, 1:m + 1, 1:n + 1] == OCEAN)
    coeff = np.zeros((6, l, m, n))
    w = np.cos(grid.y_ext[1:m + 1])[None, :, None] \
        * grid.dfzT[:, None, None]
    coeff[SS] = np.where(ocean, np.broadcast_to(w, (l, m, n)), 0.0)
    return coeff
