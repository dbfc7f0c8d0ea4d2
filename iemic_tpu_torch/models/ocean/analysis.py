"""Jacobian analysis, land-mask fix cycles, and integral checks
(PyTorch).

Port of ``iemic_tpu/models/ocean/analysis.py``, the reference's
defensive-correctness toolbox:

  * ``analyze_jacobian1``  — detect singular pressure rows (continuity
    rows with <= 2 significant entries, typically isolated water
    columns produced by a bad mask), Ocean::analyzeJacobian1
    (Ocean.C:273-341).
  * ``analyze_jacobian2``  — detect salinity columns whose volume
    integral is nonzero on a physical test state (discretization /
    masking errors that break salt conservation),
    Ocean::analyzeJacobian2 + getColumnIntegral
    (Ocean.C:343-423, 1852-1900).
  * ``mask_fix_cycle``     — iteratively turn flagged cells into LAND
    and rebuild, the 'Max mask fixes' loop of
    Ocean::getLandMask(adjustMask=true) (Ocean.C:490-570) with
    THCM::getLandMask's magic-2 fixing (THCM.C:1301-1338).
  * ``salt_advection`` / ``salt_diffusion`` — per-cell conservation
    diagnostics whose ocean integral must vanish (integrals.F90:17-89).

The flags and integrals are numpy on a host copy of the Jacobian, as in
the JAX package; the Jacobian and the solve of ``analyze_jacobian2`` run
on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.stencil import offsets, OCEAN, LAND, PP, SS
from ...utils import logging as log
from . import assembly

_OFFS = offsets()


def _valid_neighbor_mask(l: int, m: int, n: int, periodic: bool
                         ) -> np.ndarray:
    """(27, l, m, n) bool: stencil neighbor lies inside the domain
    (x wraps when periodic; matches the CRS assembly's entry dropping,
    assemble.F90 fillcolA)."""
    kk = np.arange(l)[:, None, None]
    jj = np.arange(m)[None, :, None]
    ii = np.arange(n)[None, None, :]
    valid = np.zeros((27, l, m, n), bool)
    for p in range(27):
        di, dj, dk = _OFFS[p]
        ok = ((kk + dk >= 0) & (kk + dk < l)
              & (jj + dj >= 0) & (jj + dj < m))
        if not periodic:
            ok = ok & (ii + di >= 0) & (ii + di < n)
        valid[p] = np.broadcast_to(ok, (l, m, n))
    return valid


def analyze_jacobian1(ocean) -> np.ndarray:
    """Flags (l, m, n) int: 1 = land-identity P row, 2 = problem P row
    (<= 2 significant entries, Ocean.C:273-341).  Returns the flags;
    the number of problem rows is ``(flags == 2).sum()``."""
    if ocean.jac is None:
        ocean.compute_jacobian()
    prow = ocean.jac[:, PP].cpu().numpy()    # (27, 6, l, m, n)
    _, _, l, m, n = prow.shape
    valid = _valid_neighbor_mask(l, m, n, ocean.cfg.periodic)

    v = prow * valid[:, None]
    total = v.sum(axis=(0, 1))
    el = (np.abs(v) > 1e-10).sum(axis=(0, 1))

    flags = np.zeros((l, m, n), np.int32)
    flags[total == 1.0] = 1                   # land identity rows
    problem = (total != 1.0) & (el <= 2)
    flags[problem] = 2
    found = int(problem.sum())
    if found:
        log.INFO(f"  <><>  problem P rows found: {found}")
    return flags


def column_integral(ocean, An=None, use_sres: bool = True) -> np.ndarray:
    """Volume integrals of the salinity columns of the Jacobian
    (Ocean::getColumnIntegral, Ocean.C:1852-1900): for each S column c,
    sum_rows icCoef(row) * A(row, c).  Returns (l, m, n)."""
    An = ocean.jac if An is None else An
    # only the S-S block enters: one (27, l, m, n) slice crosses to the host
    ass = (An[:, SS, SS].cpu().numpy() if isinstance(An, torch.Tensor)
           else np.asarray(An)[:, SS, SS])
    _, l, m, n = ass.shape
    icw = assembly.intcond_coeff(ocean.grid, ocean.landm)[SS]
    if use_sres and ocean.cfg.sres == 0:
        _, kic, jic, iic = ocean.rowintcon
        icw = icw.copy()
        icw[kic, jic, iic] = 0.0
    # colInt(c) = sum_p icw(c - off_p) * An[p, SS, SS, c - off_p]
    out = np.zeros((l, m, n))
    contrib = icw * ass                       # (27, l, m, n)
    for p in range(27):
        di, dj, dk = _OFFS[p]
        src = contrib[p]
        # shift src by +off to land on the column cell
        ksrc = slice(max(0, -dk), l - max(0, dk))
        kdst = slice(max(0, dk), l - max(0, -dk))
        jsrc = slice(max(0, -dj), m - max(0, dj))
        jdst = slice(max(0, dj), m - max(0, -dj))
        if ocean.cfg.periodic:
            out[kdst, jdst, :] += np.roll(src, di, axis=2)[ksrc, jsrc, :]
        else:
            isrc = slice(max(0, -di), n - max(0, di))
            idst = slice(max(0, di), n - max(0, -di))
            out[kdst, jdst, idst] += src[ksrc, jsrc, isrc]
    return out


def analyze_jacobian2(ocean) -> np.ndarray:
    """Flags (l, m, n): 2 where the S-column volume integral on a
    physical test state exceeds 1e-6 (Ocean.C:343-423).  Builds the
    test Jacobian at a one-Newton-step state from tiny forcing
    (Ocean::initialState, Ocean.C:1023-1055) and restores the model's
    state/Jacobian afterwards.

    The criterion is salt conservation, which holds only with the
    salinity integral condition ("Restoring Salinity Profile" 0): under
    salinity restoring every surface S column carries the restoring
    coefficient, so every surface ocean column would be flagged and the
    fix cycle would land the whole ocean, as the JAX package does
    (ROADMAP queue 3).  There nothing is flagged."""
    cfg = ocean.cfg
    if cfg.sres != 0:
        log.INFO("  <><>  salinity restoring: S column integrals are not "
                 "conserved, no S column flagged")
        return np.zeros((cfg.l, cfg.m, cfg.n), np.int32)
    state0, jac0 = ocean.state, ocean.jac
    par0 = ocean.get_par("Combined Forcing")
    try:
        ocean.set_par("Combined Forcing", 1e-8)
        ocean.set_state(torch.zeros_like(ocean.state))
        ocean.compute_rhs()
        ocean.compute_jacobian()
        dx = ocean.solve(-ocean.rhs)
        ocean.set_state(ocean.state + dx)
        ocean.compute_jacobian()
        ints = column_integral(ocean, use_sres=False)
    finally:
        ocean.set_par("Combined Forcing", par0)
        ocean.set_state(state0)
        ocean.jac = jac0
    flags = np.zeros(ints.shape, np.int32)
    bad = np.abs(ints) > 1e-6
    flags[bad] = 2
    found = int(bad.sum())
    if found:
        log.INFO(f"  <><>  nonzero S column integrals found: {found}")
    return flags


def apply_mask_fix(ocean, flags: np.ndarray) -> None:
    """Turn flagged (== 2) cells into LAND and rebuild the operators
    (THCM::getLandMask fix path, THCM.C:1301-1338)."""
    landm = np.asarray(ocean.landm).copy()
    l, m, n = flags.shape
    landm[1:l + 1, 1:m + 1, 1:n + 1] = np.where(
        flags == 2, LAND, landm[1:l + 1, 1:m + 1, 1:n + 1])
    ocean.set_land_mask(landm, finalized=False)


def mask_fix_cycle(ocean, max_fixes: int | None = None) -> int:
    """The reference's adjustMask loop (Ocean.C:515-570): alternately
    fix singular P rows and bad S column integrals until clean or the
    budget runs out.  Returns the number of cells landed.  The loop and
    its counters are the JAX package's, so both land the same cells."""
    if max_fixes is None:
        max_fixes = ocean.params.get("Max mask fixes")
    landed = 0
    bad_p, bad_s = 1, 1
    for _ in range(max_fixes):
        for _ in range(max_fixes):
            flags = analyze_jacobian1(ocean)
            bad_p = int((flags == 2).sum())
            if bad_p == 0:
                break
            apply_mask_fix(ocean, flags)
            landed += bad_p
            ocean.compute_jacobian()
            bad_s += 1
        if bad_s + bad_p == 0:
            break
        for _ in range(max_fixes):
            flags = analyze_jacobian2(ocean)
            bad_s = int((flags == 2).sum())
            if bad_s == 0:
                break
            apply_mask_fix(ocean, flags)
            landed += bad_s
            ocean.compute_jacobian()
            bad_p += 1
        if bad_s + bad_p == 0:
            break
    log.INFO(f"Ocean: mask fix cycle landed {landed} cells")
    return landed


# ---------------------------------------------------------------------
# conservation integrals (integrals.F90)
# ---------------------------------------------------------------------

def _fields(ocean, x):
    """U, V, W, S of the ghosted fields of x (the state by default), as
    host numpy arrays."""
    from . import nonlin
    x = ocean.state if x is None else x
    U, V, W, _, _, S = nonlin.usol(x, ocean.landm, ocean.cfg.periodic,
                                   ocean.grid)
    return [f.cpu().numpy() for f in (U, V, W, S)]


def salt_advection(ocean, x=None) -> np.ndarray:
    """Per-cell salt advection flux divergence (integrals.F90:17-50);
    its ocean-volume sum must vanish (FVM telescoping + Dirichlet
    boundaries).  Returns (l, m, n)."""
    g = ocean.grid
    l, m, n = g.l, g.m, g.n
    U, V, W, S = _fields(ocean, x)
    cosy = np.cos(g.y_ext)
    cosyv = np.cos(g.yv)
    dfzW = g.dfzW
    # Fortran index == array index; interior i=1..n, j=1..m, k=1..l.
    # u lives on (0:n, 0:m) corners: u(i,j)+u(i,j-1) is the east-face
    # mean, u(i-1,j)+u(i-1,j-1) the west-face mean (integrals.F90:36-42)
    ksl, jsl, isl = slice(1, l + 1), slice(1, m + 1), slice(1, n + 1)
    adv = ((U[ksl, jsl, 1:] + U[ksl, 0:m, 1:])
           * (S[ksl, jsl, 2:] + S[ksl, jsl, isl]) / (4 * g.dx))
    adv -= ((U[ksl, jsl, :n] + U[ksl, 0:m, :n])
            * (S[ksl, jsl, isl] + S[ksl, jsl, 0:n]) / (4 * g.dx))
    # meridional: (v(i,j)+v(i-1,j)) (s(j+1)+s(j)) cos(yv_j)
    adv += ((V[ksl, jsl, isl] + V[ksl, jsl, 0:n])
            * (S[ksl, 2:, isl] + S[ksl, jsl, isl])
            * cosyv[None, 1:m + 1, None] / (4 * g.dy))
    adv -= ((V[ksl, 0:m, isl] + V[ksl, 0:m, 0:n])
            * (S[ksl, jsl, isl] + S[ksl, 0:m, isl])
            * cosyv[None, 0:m, None] / (4 * g.dy))
    # vertical: w(k) (s(k+1)+s(k)) cos(y) / (2 dz dfzW(k)) - ...
    adv += (W[1:l + 1, jsl, isl] * (S[2:, jsl, isl] + S[ksl, jsl, isl])
            * cosy[None, jsl, None]
            / (2 * g.dz * dfzW[1:l + 1][:, None, None]))
    adv -= (W[0:l, jsl, isl] * (S[ksl, jsl, isl] + S[0:l, jsl, isl])
            * cosy[None, jsl, None]
            / (2 * g.dz * dfzW[0:l][:, None, None]))
    surf_ocean = (np.asarray(ocean.landm)[l, 1:m + 1, 1:n + 1] == OCEAN)
    return np.where(surf_ocean[None], adv, 0.0)


def salt_diffusion(ocean, x=None) -> np.ndarray:
    """Per-cell salt diffusion flux divergence (integrals.F90:53-89);
    its ocean sum must vanish for no-flux boundaries."""
    g = ocean.grid
    l, m, n = g.l, g.m, g.n
    *_, S = _fields(ocean, x)
    cosy = np.cos(g.y_ext)
    cosyv = np.cos(g.yv)
    ksl, jsl, isl = slice(1, l + 1), slice(1, m + 1), slice(1, n + 1)
    h1 = 1.0 / (g.dfzT * g.dfzW[1:])          # (l,)
    h2 = 1.0 / (g.dfzT * g.dfzW[:-1])
    cay = cosy[jsl]
    c1 = cosyv[1:m + 1]
    c2 = cosyv[0:m]
    out = (cay[None, :, None] * g.dfzT[:, None, None] * (
        (S[ksl, jsl, 2:] + S[ksl, jsl, 0:n] - 2 * S[ksl, jsl, isl])
        / (g.dx ** 2 * (cay ** 2)[None, :, None])
        + (c1[None, :, None] * S[ksl, 2:, isl]
           + c2[None, :, None] * S[ksl, 0:m, isl]
           - (c1 + c2)[None, :, None] * S[ksl, jsl, isl])
        / (g.dy ** 2 * cay[None, :, None])
        + (h1[:, None, None] * S[2:, jsl, isl]
           + h2[:, None, None] * S[0:l, jsl, isl]
           - (h1 + h2)[:, None, None] * S[ksl, jsl, isl]) / g.dz ** 2))
    ocean3 = (np.asarray(ocean.landm)[ksl, jsl, isl] == OCEAN)
    return np.where(ocean3, out, 0.0)
