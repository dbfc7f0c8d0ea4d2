"""Vertical mixing, convective adjustment, neutral physics & GM stirring
(PyTorch).

Port of ``iemic_tpu/models/ocean/mixing.py`` (the reference's ATvS-Mix
module, mix_imp.f):

  * ``mix_divergence`` — divergence of the diffusive tracer flux
                         (vmix_fun, mix_imp.f:231-562), written without
                         in-place indexing so ``torch.func`` can
                         differentiate and batch it
  * ``tprslp``/``tprstb`` — slope and stability tapers
  * ``Mixing.stencil``  — the (27, 2, 2, l, m, n) Jacobian block by the
                         27-color partition (the DSM/FDJS coloring of
                         mix_sup.F90) driving exact forward-mode
                         derivatives: ``torch.func.jvp`` batched over the
                         54 colored tangents with ``torch.func.vmap``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...grid import Grid
from ...ops.stencil import TT, SS, OCEAN, PERIO, offsets, pad_state
from . import constants as c

# zero-denominator guard, kept equal to the JAX package's value
EPSLN = 1.0e-15


def _isoc(landm: np.ndarray) -> np.ndarray:
    """'is ocean?' indicator on the padded mask (mix_imp.f:817-835);
    PERIO cells count as ocean."""
    return ((landm == OCEAN) | (landm == PERIO)).astype(np.float64)


def pad_ts(x: torch.Tensor, periodic: bool) -> torch.Tensor:
    """Padded (T, S) ghost fields, shape (2, l+2, m+2, n+2): zero ghosts
    except the periodic x-wrap (every ghost gradient is killed by isoc)."""
    return pad_state(x[TT:SS + 1], periodic)


def _min_mag(d: torch.Tensor) -> torch.Tensor:
    """Sign-preserving minimum magnitude EPSLN (exact zero -> +EPSLN)."""
    sgn = torch.where(d < 0.0, torch.full_like(d, -EPSLN),
                      torch.full_like(d, EPSLN))
    return torch.where(torch.abs(d) < EPSLN, sgn, d)


def tprslp(drdh, drdz, delta, tap: int):
    """Slope + taper (mix_imp.f:675-727), with double-where guards so
    forward-mode derivatives stay finite."""
    drdz = _min_mag(drdz)
    slp = torch.clamp(-drdh / drdz, -1.0e12, 1.0e12)
    absslp = torch.abs(slp)
    if tap == 1:        # Gerdes et al. (1991)
        steep = absslp > delta
        safe = torch.where(steep, absslp, 1.0)
        tpr = torch.where(steep, (delta / safe) ** 2, 1.0)
    elif tap == 2:      # Danabasoglu & McWilliams (1995)
        tpr = 0.5 * (1.0 - torch.tanh((absslp - delta) / delta))
    elif tap == 3:      # De Niet et al. (2007)
        dum = absslp / delta
        cubic = 1.0 - 3.0 * dum ** 2 + 2.0 * dum ** 3
        tpr = torch.where((absslp < delta) & (drdz < 0.0), cubic, 0.0)
    else:
        tpr = torch.ones_like(absslp)
    return slp, tpr


def tprstb(grad, spl, alphaT: float):
    """Stability taper (mix_imp.f:837-856)."""
    return torch.clamp(torch.tanh((-grad * alphaT * spl) ** 3), min=0.0)


def _precompute(grid: Grid, landm: np.ndarray, *, device,
                dtype=torch.float64) -> dict:
    """Static geometry for mix_divergence, as tensors on ``device``."""
    l, m, n = grid.l, grid.m, grid.n

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(
        iso=t(_isoc(landm)), cosy=t(np.cos(grid.y_ext)),
        cosyv=t(np.cos(grid.yv)), dfzT=t(grid.dfzT), dfzW=t(grid.dfzW),
        dx=grid.dx, dy=grid.dy, dz=grid.dz,
        ocean3=t(landm[1:l + 1, 1:m + 1, 1:n + 1] == OCEAN),
        delta_scale=c.R0DIM / grid.hdim)


def mix_divergence(TS: torch.Tensor, par: torch.Tensor, geo: dict, *,
                   tap: int, rho_mixing: bool) -> torch.Tensor:
    """vmix_fun (mix_imp.f:231-562): (2, l+2, m+2, n+2) padded (T,S)
    -> (2, l, m, n) divergence of the diffusive flux, with the sign it
    has in this framework's residual F = An x - Frc + mix."""
    Tp, Sp = TS[0], TS[1]
    lp2, mp2, np2 = Tp.shape
    l, m, n = lp2 - 2, mp2 - 2, np2 - 2

    iso, cosy, cosyv = geo["iso"], geo["cosy"], geo["cosyv"]
    dfzT, dfzW = geo["dfzT"], geo["dfzW"]
    dx, dy, dz = geo["dx"], geo["dy"], geo["dz"]

    lam = par[c.LAMB]
    xes = par[c.NLES]
    piso = par[c.MIXP] * par[c.PE_H]
    pgm = par[c.MKAP] * par[c.PE_H]
    eps = (1.0 - par[c.ALPC]) * par[c.ENER] * par[c.PE_V]
    kvc = par[c.P_VC]
    sp1 = par[c.SPL1]
    delta = geo["delta_scale"] * par[c.SPL2]
    alphaT = geo["alphaT"]

    def dcdx(C):        # east face: (l+2, m+2, n+1)
        return (iso[:, :, 1:] * iso[:, :, :-1] * (C[:, :, 1:] - C[:, :, :-1])
                / (dx * cosy[None, :, None]))

    def dcdy(C):        # north face: (l+2, m+1, n+2)
        return iso[:, 1:, :] * iso[:, :-1, :] * (C[:, 1:, :] - C[:, :-1, :]) / dy

    def dcdz(C):        # top face: (l+1, m+2, n+2)
        return (iso[1:, :, :] * iso[:-1, :, :] * (C[1:, :, :] - C[:-1, :, :])
                / (dz * dfzW[:, None, None]))

    dtdxe, dsdxe = dcdx(Tp), dcdx(Sp)
    dtdyn, dsdyn = dcdy(Tp), dcdy(Sp)
    dtdzt, dsdzt = dcdz(Tp), dcdz(Sp)

    # density derivative wrt T (drhodC, mix_imp.f:643-673); drho/dS = lam
    rho = lam * Sp - Tp - xes * (c.ALPT1 * Tp + c.ALPT2 * Tp ** 2
                                 - c.ALPT3 * Tp ** 3)
    drhodt = -1.0 - xes * (c.ALPT1 + 2.0 * c.ALPT2 * Tp
                           - 3.0 * c.ALPT3 * Tp ** 2)
    drhodzt = dcdz(rho)

    ksl = slice(1, l + 1)
    jsl = slice(1, m + 1)
    isl = slice(1, n + 1)
    zero = torch.zeros((), dtype=TS.dtype, device=TS.device)

    # -- east-face fluxes: (l, m, n+1) --------------------------------
    Ftxe = zero
    Fsxe = zero
    for kr in (0, 1):
        for ip in (0, 1):
            rt = drhodt[ksl, jsl, ip:n + 1 + ip]
            gtz = dtdzt[kr:l + kr, jsl, ip:n + 1 + ip]
            gsz = dsdzt[kr:l + kr, jsl, ip:n + 1 + ip]
            gtx = dtdxe[ksl, jsl, :]
            gsx = dsdxe[ksl, jsl, :]
            slp, tpr = tprslp(rt * gtx + lam * gsx, rt * gtz + lam * gsz,
                              delta, tap)
            w = dfzW[kr:l + kr, None, None]
            Ftxe = Ftxe + w * (tpr * piso * gtx + tpr * (piso - pgm) * slp * gtz)
            Fsxe = Fsxe + w * (tpr * piso * gsx + tpr * (piso - pgm) * slp * gsz)
    Ftxe = -Ftxe / (4.0 * dfzT[:, None, None])
    Fsxe = -Fsxe / (4.0 * dfzT[:, None, None])

    # -- north-face fluxes: (l, m+1, n), face j = 0 stays zero ---------
    Ft = zero
    Fs = zero
    for kr in (0, 1):
        for jq in (0, 1):
            rt = drhodt[ksl, 1 + jq:m + 1 + jq, isl]
            gtz = dtdzt[kr:l + kr, 1 + jq:m + 1 + jq, isl]
            gsz = dsdzt[kr:l + kr, 1 + jq:m + 1 + jq, isl]
            gty = dtdyn[ksl, 1:m + 1, isl]
            gsy = dsdyn[ksl, 1:m + 1, isl]
            slp, tpr = tprslp(rt * gty + lam * gsy, rt * gtz + lam * gsz,
                              delta, tap)
            w = dfzW[kr:l + kr, None, None] * cosy[None, 1 + jq:m + 1 + jq, None]
            Ft = Ft + w * (tpr * piso * gty + tpr * (piso - pgm) * slp * gtz)
            Fs = Fs + w * (tpr * piso * gsy + tpr * (piso - pgm) * slp * gsz)
    den = 4.0 * dfzT[:, None, None] * cosyv[None, 1:m + 1, None]
    zrow = torch.zeros((l, 1, n), dtype=TS.dtype, device=TS.device)
    Ftyn = torch.cat([zrow, -Ft / den], dim=1)
    Fsyn = torch.cat([zrow, -Fs / den], dim=1)

    # -- top-face fluxes: (l+1, m, n), face k = 0 stays zero -----------
    Ft = zero
    Fs = zero
    gtzc = dtdzt[1:l + 1, jsl, isl]
    gszc = dsdzt[1:l + 1, jsl, isl]
    for kr in (0, 1):
        rt = drhodt[1 + kr:l + 1 + kr, jsl, isl]
        for gt, gs in [(dtdxe[1 + kr:l + 1 + kr, jsl, ip:n + ip],
                        dsdxe[1 + kr:l + 1 + kr, jsl, ip:n + ip])
                       for ip in (0, 1)] + \
                      [(dtdyn[1 + kr:l + 1 + kr, jq:m + jq, isl],
                        dsdyn[1 + kr:l + 1 + kr, jq:m + jq, isl])
                       for jq in (0, 1)]:
            slp, tpr = tprslp(rt * gt + lam * gs, rt * gtzc + lam * gszc,
                              delta, tap)
            Ft = Ft + tpr * piso * slp * slp * gtzc + tpr * (piso + pgm) * slp * gt
            Fs = Fs + tpr * piso * slp * slp * gszc + tpr * (piso + pgm) * slp * gs
    Ftzt = -Ft / 4.0
    Fszt = -Fs / 4.0

    # energetically consistent vertical mixing (eps term)
    stb = tprstb(drhodzt[1:l + 1, jsl, isl], sp1, alphaT)
    dsafe = _min_mag(drhodzt[1:l + 1, jsl, isl] - EPSLN)
    Ftzt = Ftzt + stb * eps * gtzc / dsafe
    Fszt = Fszt + stb * eps * gszc / dsafe
    zlay = torch.zeros((1, m, n), dtype=TS.dtype, device=TS.device)
    Ftzt = torch.cat([zlay, Ftzt], dim=0)
    Fszt = torch.cat([zlay, Fszt], dim=0)

    # implicit vertical mixing / convective adjustment (P_VC term)
    cadj = tprstb(-drhodzt[1:l + 1, jsl, isl], sp1, alphaT) * kvc
    Ftimp = torch.cat([zlay, -cadj * gtzc], dim=0)
    Fsimp = torch.cat([zlay, -cadj * gszc], dim=0)

    # -- flux divergences ---------------------------------------------
    cy = cosy[None, 1:m + 1, None]
    dzT = dz * dfzT[:, None, None]
    divT = ((Ftxe[:, :, 1:] - Ftxe[:, :, :-1]) / (dx * cy)
            + (Ftyn[:, 1:, :] * cosyv[None, 1:, None]
               - Ftyn[:, :-1, :] * cosyv[None, :-1, None]) / (dy * cy)
            + (Ftzt[1:] - Ftzt[:-1]) / dzT)
    divS = ((Fsxe[:, :, 1:] - Fsxe[:, :, :-1]) / (dx * cy)
            + (Fsyn[:, 1:, :] * cosyv[None, 1:, None]
               - Fsyn[:, :-1, :] * cosyv[None, :-1, None]) / (dy * cy)
            + (Fszt[1:] - Fszt[:-1]) / dzT)

    dFti = Ftimp[1:] - Ftimp[:-1]
    dFsi = Fsimp[1:] - Fsimp[:-1]
    if rho_mixing:
        # mix density instead of T and S when the EOS is linear
        # (mix_imp.f:512-524, 544-556)
        lin_eos = xes == 0.0
        impT = torch.where(lin_eos, (dFti - dFsi * lam) / (2.0 * dzT),
                           dFti / dzT)
        impS = torch.where(lin_eos, (dFsi - dFti / lam) / (2.0 * dzT),
                           dFsi / dzT)
    else:
        impT = dFti / dzT
        impS = dFsi / dzT

    ocean3 = geo["ocean3"]
    return torch.stack([(divT + impT) * ocean3, (divS + impS) * ocean3])


class Mixing:
    """Precomputed mixing operator bound to one grid + landmask.

    ``rhs(x, par)``     -> (2, l, m, n) mixing term on the (T, S) rows
    ``stencil(x, par)`` -> (27, 2, 2, l, m, n) exact Jacobian block

    vmix=1 is always active, vmix=2 gates each row on whether its field
    is nonzero (vmix_control, mix_imp.f:131-166).
    """

    def __init__(self, grid: Grid, landm: np.ndarray, *, vmix: int,
                 tap: int, rho_mixing: bool, alphaT: float,
                 periodic: bool, device):
        self.vmix = vmix
        self.tap = tap
        self.rho_mixing = rho_mixing
        self.periodic = periodic
        self.geo = _precompute(grid, landm, device=device)
        self.geo["alphaT"] = alphaT
        l, m, n = grid.l, grid.m, grid.n
        self.shape = (l, m, n)
        # 27-color index: for stencil slot p at row (k,j,i) the colored
        # seed hitting neighbor (k+dk, j+dj, i+di) has color
        # 9*((k+1+dk)%3) + 3*((j+1+dj)%3) + ((i+1+di)%3)  (padded idx)
        offs = offsets()
        kk = np.arange(l)[:, None, None]
        jj = np.arange(m)[None, :, None]
        ii = np.arange(n)[None, None, :]
        cidx = np.empty((27, l, m, n), np.int64)
        for p in range(27):
            di, dj, dk = offs[p]
            cidx[p] = (9 * ((kk + 1 + dk) % 3) + 3 * ((jj + 1 + dj) % 3)
                       + ((ii + 1 + di) % 3))
        self.color_index = torch.as_tensor(cidx, device=device)
        # the 54 colored seeds: seed 27*b + color marks every third
        # padded cell of color `color` in variable b
        kp = np.arange(l + 2)[:, None, None] % 3
        jp = np.arange(m + 2)[None, :, None] % 3
        ip = np.arange(n + 2)[None, None, :] % 3
        seeds = np.zeros((2, 27, 2, l + 2, m + 2, n + 2))
        for cc in range(27):
            mask = (kp == cc // 9) & (jp == (cc // 3) % 3) & (ip == cc % 3)
            for b in range(2):
                seeds[b, cc, b] = mask
        self.seeds = torch.as_tensor(seeds.reshape(54, 2, l + 2, m + 2,
                                                   n + 2),
                                     dtype=torch.float64, device=device)

    def _active(self, x: torch.Tensor) -> torch.Tensor:
        """(2,) activity gates for the T and S rows."""
        if self.vmix <= 1:
            return torch.ones((2,), dtype=x.dtype, device=x.device)
        nt = torch.sqrt(torch.sum(x[TT] ** 2))
        ns = torch.sqrt(torch.sum(x[SS] ** 2))
        return torch.stack([nt > 1e-12, ns > 1e-12]).to(x.dtype)

    def rhs(self, x: torch.Tensor, par: torch.Tensor,
            active: torch.Tensor | None = None) -> torch.Tensor:
        """Mixing contribution to the residual F = An x - Frc + mix.
        active overrides the (2,) gates of x (a window of a state whose
        gates come from the whole state)."""
        mix = mix_divergence(pad_ts(x, self.periodic), par, self.geo,
                             tap=self.tap, rho_mixing=self.rho_mixing)
        if active is None:
            active = self._active(x)
        return mix * active[:, None, None, None]

    def stencil(self, x: torch.Tensor, par: torch.Tensor,
                active: torch.Tensor | None = None) -> torch.Tensor:
        """Exact (27, 2, 2, l, m, n) Jacobian block d mix / d (T, S): each
        color seeds every third padded cell in each dimension, so each
        residual row sees exactly one seeded neighbor per color and the
        tangent output *is* that stencil entry.  active as in ``rhs``."""
        l, m, n = self.shape
        TS0 = pad_ts(x, self.periodic)

        def f(TS):
            return mix_divergence(TS, par, self.geo, tap=self.tap,
                                  rho_mixing=self.rho_mixing)

        def tangent(seed):
            return torch.func.jvp(f, (TS0,), (seed.to(TS0.dtype),))[1]

        outs = torch.func.vmap(tangent)(self.seeds)   # (54, 2, l, m, n)
        outs = outs.reshape(2, 27, 2, l, m, n)        # [b, color, a, ...]
        blk = torch.stack([
            torch.stack([torch.gather(outs[b, :, a], 0, self.color_index)
                         for b in range(2)], dim=1)
            for a in range(2)], dim=1)                # (27, a, b, l, m, n)
        if active is None:
            active = self._active(x)
        return blk * active[None, :, None, None, None, None]
