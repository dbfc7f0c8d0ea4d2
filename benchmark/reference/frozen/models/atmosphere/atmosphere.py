"""Energy-balance moisture atmosphere model (T_a, q, albedo + global P)
(PyTorch).

Port of ``iemic_tpu/models/atmosphere/atmosphere.py`` (the reference's
src/atmosphere/AtmosLocal.C/H + Atmosphere.C/H): a 2D energy-balance /
moisture / albedo model with three unknowns per cell (T_a, q anomaly,
albedo) and one auxiliary global precipitation anomaly P, on the ocean's
lat-lon grid with a 5-point diffusion stencil held in a 9-point
``(9, 3, 3, m, n)`` tensor, plus the heat fluxes, evaporation and
precipitation, the snow/ice albedo with tanh switches (AtmosLocal.C:1120)
and the integral condition for q with the global precipitation row
(Atmosphere.C:1010-1100).

Where the JAX package takes the albedo equation's derivatives with
``jax.grad``/``jax.jacfwd``, here they are in closed form: the equation is
a product of three tanh switches.  The direct solve assembles the dense
matrix once per Jacobian (batched matvecs on identity columns, as the JAX
package's ``vmap``), factors it with ``torch.linalg.lu_factor`` and reuses
the factors until the Jacobian changes (``add_mass_to_jacobian`` makes a
new one).

Every tensor lives on ``device`` in float64.  State layout: flat
(3*n*m + aux,) in the reference's row ordering
row = 3*(j*n + i) + XX, the auxiliary P last (AtmosLocal.C:1496-1517).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as tF

from ...config import ParameterList
from ...utils import logging as log

F64 = torch.float64
NUN = 3
TT, QQ, AA = 0, 1, 2


def default_atmosphere_params() -> ParameterList:
    """Defaults from AtmosLocal::setParameters (AtmosLocal.C:105-170)
    and the parallel Atmosphere constructor (Atmosphere.C:20-46)."""
    p = ParameterList("Atmosphere")
    p.set("Global Grid-Size n", 16)
    p.set("Global Grid-Size m", 16)
    p.set("Global Grid-Size l", 1)
    p.set("Global Bound xmin", 286.0)
    p.set("Global Bound xmax", 350.0)
    p.set("Global Bound ymin", 10.0)
    p.set("Global Bound ymax", 74.0)
    p.set("Periodic", False)
    p.set("Auxiliary unknowns", 1)
    p.set("Use integral condition", True)
    p.set("Use idealized precipitation", False)
    p.set("atmospheric density", 1.25)
    p.set("oceanic density", 1024.0)
    p.set("atmospheric scale height", 8400.0)
    p.set("humidity scale height", 1800.0)
    p.set("vertical length scale", 4000.0)
    p.set("heat capacity", 1000.0)
    p.set("temperature eddy diffusivity", 3.1e+06)
    p.set("humidity eddy diffusivity", 1e+06)
    p.set("radiative flux param A", 212.0)
    p.set("radiative flux param B", 1.5)
    p.set("solar constant", 1360.0)
    p.set("atmospheric absorption coefficient", 0.43)
    p.set("Dalton number", 1.3e-03)
    p.set("exchange coefficient ch", 0.94 * 1.3e-03)
    p.set("mean atmospheric surface wind speed", 8.5)
    p.set("background temperature atmosphere", 15.0)
    p.set("background temperature ocean", 15.0)
    p.set("background temperature seaice", -5.0)
    p.set("temperature scale", 1.0)
    p.set("atmos reference humidity", 2e-3)
    p.set("atmos humidity scale", 1e-3)
    p.set("latent heat of vaporization", 2.5e06)
    p.set("horizontal velocity of the ocean", 0.1)
    p.set("radius of the earth", 6.37e+06)
    p.set("reference albedo", 0.3)
    p.set("albedo excursion", 0.5)
    p.set("restoring timescale tauf (in days)", 1.0)
    p.set("restoring timescale tauc (in days)", 1.0)
    p.set("melt temperature threshold (deg C)", 0.0)
    p.set("rain/snow temperature threshold (deg C)", 1.0)
    p.set("accumulation precipitation threshold (m/y)", 0.2)
    p.set("melt threshold width (deg C)", 5.0)
    p.set("rain/snow threshold width (deg C)", 1.0)
    p.set("accumulation threshold width (m/y)", 0.1)
    # continuation parameters (AtmosLocal.C:152-170)
    p.set("Combined Forcing", 0.0)
    p.set("Solar Forcing", 1.0)
    p.set("Longwave Forcing", 1.0)
    p.set("Humidity Forcing", 1.0)
    p.set("Latent Heat Forcing", 1.0)
    p.set("Albedo Forcing", 1.0)
    p.set("T Eddy Diffusivity", 1.0)
    # dependencies normally provided by the ocean (m_atm defaults
    # Ooa = Os = 1.0, reference atm.F90:26-29)
    p.set("Ooa", 1.0)
    p.set("Os", 1.0)
    return p


PAR_ORDER = ["Combined Forcing", "Solar Forcing", "Longwave Forcing",
             "Humidity Forcing", "Latent Heat Forcing", "Albedo Forcing",
             "T Eddy Diffusivity"]
(P_COMB, P_SUNP, P_LONF, P_HUMF, P_LATF, P_ALBF, P_TDIF) = range(7)

# columns per batch of the dense assembly (batched matvecs on identity
# columns): at 64x32, 1024 columns take 0.45 GB of windows in f64
_DENSE_BATCH = 1024


class AtmosJac(NamedTuple):
    """Assembled dependency structure: 9-point 2D stencil blocks,
    dense coupling to the auxiliary P, and the P-row coefficients."""
    stencil: torch.Tensor   # (9, 3, 3, m, n)
    col_P: torch.Tensor     # (3, m, n) dependency of each eq on P
    prow_q: torch.Tensor    # (m, n) P-row coefficients on q
    prow_P: torch.Tensor    # scalar P->P coefficient


# 2D stencil offsets matching the reference's 9-point numbering
# (loc 1..9; di = (loc-1)//3 - 1, dj = (loc-1)%3 - 1)
_OFFS2D = [((p // 3) - 1, (p % 3) - 1) for p in range(9)]


def _switch(x, eps):
    """H(x) = (1 + tanh(x/eps))/2 and its derivative (AtmosLocal.H:436)."""
    t = torch.tanh(x / eps)
    return 0.5 * (1.0 + t), 0.5 * (1.0 - t * t) / eps


class Atmosphere:
    """Atmosphere model implementing the Model contract."""

    def __init__(self, params: ParameterList | dict | None = None,
                 surfmask: np.ndarray | None = None, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Atmosphere: device cuda but no CUDA device "
                               "(pass device=\"cpu\" to run on the CPU)")
        if params is None:
            params = ParameterList("Atmosphere")
        if isinstance(params, dict):
            params = ParameterList("Atmosphere", params)
        params.validate_and_set_defaults(default_atmosphere_params())
        self.params = params
        g = params.get

        self.n = g("Global Grid-Size n")
        self.m = g("Global Grid-Size m")
        self.l = g("Global Grid-Size l")
        self.aux = g("Auxiliary unknowns")
        self.periodic = bool(g("Periodic"))
        self.use_intcond_q = bool(g("Use integral condition"))
        n, m, l = self.n, self.m, self.l
        self.dim = NUN * n * m * l + self.aux

        self.xmin = np.deg2rad(g("Global Bound xmin"))
        self.xmax = np.deg2rad(g("Global Bound xmax"))
        self.ymin = np.deg2rad(g("Global Bound ymin"))
        self.ymax = np.deg2rad(g("Global Bound ymax"))
        self.dx = (self.xmax - self.xmin) / n
        self.dy = (self.ymax - self.ymin) / m

        j = np.arange(m + 1, dtype=np.float64)
        self.yv = self.ymin + j * self.dy            # yv[0..m]
        self.yc = self.ymin + (j - 0.5) * self.dy    # yc[0..m]; yc[j] j>=1
        self.datc = 0.9 + 1.5 * np.exp(-12 * self.yc ** 2 / np.pi)
        self.datv = 0.9 + 1.5 * np.exp(-12 * self.yv ** 2 / np.pi)

        # physical parameters (setup(), AtmosLocal.C:172-260)
        self.rhoa = g("atmospheric density")
        self.rhoo = g("oceanic density")
        self.hdima = g("atmospheric scale height")
        self.hdimq = g("humidity scale height")
        self.cpa = g("heat capacity")
        self.D0 = g("temperature eddy diffusivity")
        self.kappa = g("humidity eddy diffusivity")
        self.arad = g("radiative flux param A")
        self.brad = g("radiative flux param B")
        self.sun0 = g("solar constant")
        self.c0 = g("atmospheric absorption coefficient")
        self.ce = g("Dalton number")
        self.ch = g("exchange coefficient ch")
        self.uw = g("mean atmospheric surface wind speed")
        self.t0a = g("background temperature atmosphere")
        self.t0o = g("background temperature ocean")
        self.t0i = g("background temperature seaice")
        self.tdim = g("temperature scale")
        self.q0 = g("atmos reference humidity")
        self.qdim = g("atmos humidity scale")
        self.lv = g("latent heat of vaporization")
        self.udim = g("horizontal velocity of the ocean")
        self.r0dim = g("radius of the earth")
        self.a0 = g("reference albedo")
        self.da = g("albedo excursion")
        self.tauf = g("restoring timescale tauf (in days)") \
            * 3600.0 * 24.0 * self.udim / self.r0dim
        self.tauc = g("restoring timescale tauc (in days)") \
            * 3600.0 * 24.0 * self.udim / self.r0dim
        self.Tm = g("melt temperature threshold (deg C)") - self.t0o
        self.Tr = g("rain/snow temperature threshold (deg C)") - self.t0o
        self.Pa = g("accumulation precipitation threshold (m/y)")
        self.epm = g("melt threshold width (deg C)")
        self.epr = g("rain/snow threshold width (deg C)")
        self.epa = g("accumulation threshold width (m/y)")

        self.muoa = self.rhoa * self.ch * self.cpa * self.uw
        self.amua = (self.arad + self.brad * self.t0a) / self.muoa
        self.bmua = self.brad / self.muoa
        self.Ai = self.rhoa * self.hdima * self.cpa * self.udim \
            / (self.r0dim * self.muoa)
        self.Ad = self.rhoa * self.hdima * self.cpa * self.D0 \
            / (self.muoa * self.r0dim ** 2)
        self.As = self.sun0 * (1 - self.c0) / (4 * self.muoa)
        self.eta = (self.rhoa / self.rhoo) * self.ce * self.uw
        self.Phv = self.kappa / (self.udim * self.r0dim)

        # saturation humidity (Bolton 1980, AtmosLocal.C:199-242)
        c1, c2, c3, c4, c5 = 3.8e-3, 21.87, 265.5, 17.67, 243.5
        self.qso = c1 * np.exp(c4 * self.t0o / (self.t0o + c5))
        self.qsi = c1 * np.exp(c2 * self.t0i / (self.t0i + c3))
        self.Eo0 = self.eta * (self.qso - self.q0)
        self.Ei0 = self.eta * (self.qsi - self.q0)
        self.Cs = (self.Ei0 - self.Eo0) / self.eta / self.qdim
        self.Po0 = self.Eo0
        self.dqso = 5e-4    # reference hack (AtmosLocal.C:233)
        self.dqsi = (c1 * c2 * c3) / (self.t0i + c3) ** 2 \
            * np.exp(c2 * self.t0i / (self.t0i + c3))
        self.lvscale = self.rhoo * self.lv / self.muoa

        # ocean-provided coefficients (reference getdeps / atm.F90);
        # updated by the coupled model's synchronize
        self.Ooa = float(g("Ooa"))
        self.Os = float(g("Os"))

        self.par = self._tensor([g(name) for name in PAR_ORDER])
        self._update_sun()

        # surface mask (m, n) int: 1 = land
        if surfmask is None:
            surfmask = np.zeros((m, n), dtype=np.int32)
        self.surfmask = np.asarray(surfmask).astype(np.int32)
        ocean_srf = (self.surfmask == 0)

        # integral coefficients (AtmosLocal.C:560-583): cos(yc) dx dy
        w = np.cos(self.yc[1:m + 1])[:, None] * self.dx * self.dy
        self.ic_coeff = np.broadcast_to(w, (m, n)).copy()     # all cells
        self.p_coeff = np.where(ocean_srf, self.ic_coeff, 0.0)
        self.total_area = float(self.p_coeff.sum())

        # precipitation distribution (AtmosLocal.C:495-516 fillPdist),
        # adjusted so its area integral is 1 (computePrecipitation)
        y2d = np.broadcast_to(self.yc[1:m + 1][:, None], (m, n))
        pdist = 2 * np.exp(-(6 * y2d) ** 2) + np.sin(2.0 * y2d) ** 2
        pdist = np.where(ocean_srf, pdist, 0.0)
        int_pdist = float((self.p_coeff * pdist).sum()) / self.total_area
        self.pdist = np.where(np.abs(pdist) > 0.0,
                              pdist + 1.0 - int_pdist, 0.0)

        self._ocean_srf = self._tensor(ocean_srf.astype(np.float64))
        self._land_srf = 1.0 - self._ocean_srf
        self._leg_j = self._tensor(self.leg[1:m + 1])[:, None]
        self._pdist = self._tensor(self.pdist)
        self._ic_coeff = self._tensor(self.ic_coeff)
        self._p_coeff = self._tensor(self.p_coeff)
        self._txx_tyy = self._tensor(self._d2_atoms(True))
        self._qxx_qyy = self._tensor(self._d2_atoms(False))

        # external fields
        self.sst = self._tensor(np.zeros((m, n)))
        self.sit = self._tensor(np.zeros((m, n)))
        self.msi = self._tensor(np.zeros((m, n)))

        # state / results
        self.state = self._tensor(np.zeros(self.dim))
        self.rhs = torch.zeros_like(self.state)
        self.sol = torch.zeros_like(self.state)
        self.jac: AtmosJac | None = None
        self.diagB = None
        self._lu = None           # (jac it factors, LU, pivots)
        log.INFO(f"Atmosphere: initialized {n}x{m} grid, dim={self.dim}, "
                 f"device={self.device}")

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                               device=self.device)

    # ------------------------------------------------------------------
    def _update_sun(self):
        leg = 1.0 - 0.482 * (3 * np.sin(self.yc) ** 2 - 1.0) / 2.0
        self.leg = leg                # latitudinal profile, index j (0..m)
        self.suna = self.As * leg
        self.suno = self.Os * leg

    def _d2_atoms(self, dat_on: bool) -> np.ndarray:
        """(9, m, n) atoms for xx+yy diffusion with optional latitudinal
        diffusivity profile dat (discretize, AtmosLocal.C:1141+)."""
        m, n, yc = self.m, self.n, self.yc
        atom = np.zeros((9, m, n))
        cosdx2i = 1.0 / (np.cos(yc[1:m + 1]) * self.dx) ** 2
        datc = self.datc[1:m + 1] if dat_on else np.ones(m)
        v2 = (datc * cosdx2i)[:, None] * np.ones((m, n))
        atom[1] += v2      # loc 2 (west)
        atom[7] += v2      # loc 8 (east)
        atom[4] += -2 * v2
        dy2i = 1.0 / self.dy ** 2
        datv = self.datv if dat_on else np.ones(m + 1)
        v4 = (dy2i * datv[0:m] * np.cos(self.yv[0:m])
              / np.cos(yc[1:m + 1]))[:, None] * np.ones((m, n))
        v6 = (dy2i * datv[1:m + 1] * np.cos(self.yv[1:m + 1])
              / np.cos(yc[1:m + 1]))[:, None] * np.ones((m, n))
        atom[3] += v4      # loc 4 (south)
        atom[5] += v6      # loc 6 (north)
        atom[4] += -(v4 + v6)
        return atom

    # -- state helpers -------------------------------------------------
    def split(self, x):
        """flat (..., dim) -> ((..., 3, m, n) fields, P (...))."""
        n, m, l = self.n, self.m, self.l
        lead = x.shape[:-1]
        fields = x[..., :NUN * n * m * l].reshape(*lead, m, n, NUN) \
            .movedim(-1, -3)
        P = x[..., -1] if self.aux == 1 else x.new_zeros(lead)
        return fields, P

    def join(self, fields, P):
        lead = fields.shape[:-3]
        flat = fields.movedim(-3, -1).reshape(*lead, -1)
        if self.aux == 1:
            flat = torch.cat([flat, P.reshape(*lead, 1)], dim=-1)
        return flat

    # ------------------------------------------------------------------
    def _boundaries(self, st):
        """Fold west/east (non-periodic) and north/south stencil legs into
        the center for the diagonal (XX,XX) entries
        (AtmosLocal.C:1436-1478); in place."""
        n, m = self.n, self.m
        for a in range(NUN):
            if not self.periodic:
                st[4, a, a, :, 0] += st[1, a, a, :, 0]
                st[1, a, a, :, 0] = 0.0
                st[4, a, a, :, n - 1] += st[7, a, a, :, n - 1]
                st[7, a, a, :, n - 1] = 0.0
            st[4, a, a, m - 1, :] += st[5, a, a, m - 1, :]
            st[5, a, a, m - 1, :] = 0.0
            st[4, a, a, 0, :] += st[3, a, a, 0, :]
            st[3, a, a, 0, :] = 0.0
        return st

    def _albedo_switch(self, A, Ta, P, comb, sunp, Ooa, Os):
        """aF (AtmosLocal.C:1120-1139) and its derivatives in A, Ta and P
        (closed form of the JAX package's autodiff)."""
        dTl_dA = -comb * sunp * (Os * self._leg_j) * self.da / Ooa
        tl = Ta + comb * sunp * (Os * self._leg_j) \
            * ((1 - self.a0) - self.da * A) / Ooa
        year = 3600.0 * 24.0 * 365.0
        dimP = year * self._pdist * (self.Po0 + self.eta * self.qdim * P)
        h1, d1 = _switch(self.Tm - tl, self.epm)
        h2, d2 = _switch(self.Tr - tl, self.epr)
        h3, d3 = _switch(dimP - self.Pa, self.epa)
        aF = h1 * h2 * h3
        daF_dtl = -(d1 * h2 + h1 * d2) * h3
        daF_dP = h1 * h2 * d3 * year * self._pdist * self.eta * self.qdim
        return aF, daF_dtl * dTl_dA, daF_dtl, daF_dP

    def _nuq(self, par):
        return par[P_COMB] * par[P_HUMF] * (self.eta / self.hdimq) \
            * (self.rhoo / self.rhoa) * (self.r0dim / self.udim)

    def _jac_fn(self, x, par, sst, sit, msi, Ooa, Os) -> AtmosJac:
        """Dependency assembly (computeJacobian, AtmosLocal.C:585-780),
        with exact albedo derivatives where the reference takes finite
        differences (AtmosLocal.H:460-470)."""
        m, n = self.m, self.n
        comb, sunp, albf, latf, tdif = (par[P_COMB], par[P_SUNP],
                                        par[P_ALBF], par[P_LATF],
                                        par[P_TDIF])
        nuq = self._nuq(par)
        ocean_srf, land_srf = self._ocean_srf, self._land_srf
        fields, P = self.split(x)
        Ta, A = fields[TT], fields[AA]

        st = torch.zeros((9, NUN, NUN, m, n), dtype=x.dtype,
                         device=x.device)
        # TT,TT: tdif*Ad*(txx+tyy) - tc - bmua*tc2
        st[:, TT, TT] = tdif * self.Ad * self._txx_tyy
        st[4, TT, TT] += -ocean_srf - self.bmua
        # TT,AA diag
        dTadA = -comb * sunp * (self.As * self._leg_j) * self.da
        dTldA = -comb * sunp * (Os * self._leg_j) * self.da / Ooa
        st[4, TT, AA] = land_srf * (dTldA + dTadA) + ocean_srf * dTadA
        # QQ,QQ: Phv*(qxx+qyy) - nuq*qc
        st[:, QQ, QQ] = self.Phv * self._qxx_qyy
        st[4, QQ, QQ] += -nuq * ocean_srf

        _, daFdA, daFdT, daFdP = self._albedo_switch(A, Ta, P, comb, sunp,
                                                     Ooa, Os)
        st[4, AA, AA] = land_srf * (comb * albf * daFdA - 1.0) / self.tauf \
            + ocean_srf * (-1.0 / self.tauc)
        st[4, AA, TT] = land_srf * comb * albf * daFdT / self.tauf

        # dependencies on the auxiliary P
        col_P = torch.zeros((NUN, m, n), dtype=x.dtype, device=x.device)
        if self.aux == 1:
            col_P[TT] = comb * latf * self.lvscale * self.eta \
                * self.qdim * self._pdist
            col_P[QQ] = -nuq * self._pdist
            col_P[AA] = land_srf * comb * albf * daFdP / self.tauf

        st = self._boundaries(st)
        prow_q = -self._p_coeff / self.total_area
        return AtmosJac(stencil=st, col_P=col_P, prow_q=prow_q,
                        prow_P=torch.tensor(-1.0, dtype=x.dtype,
                                            device=x.device))

    def _matvec(self, J: AtmosJac, v):
        """J v for v of shape (..., dim)."""
        m, n = self.m, self.n
        fields, P = self.split(v)
        # pad with zeros (or periodic wrap) in x; walls in y
        fp = tF.pad(fields, (1, 1, 1, 1))
        if self.periodic:
            fp = torch.cat([fp[..., n:n + 1], fp[..., 1:n + 1],
                            fp[..., 1:2]], dim=-1)
        windows = torch.stack([fp[..., 1 + dj:1 + dj + m, 1 + di:1 + di + n]
                               for (di, dj) in _OFFS2D], dim=-4)
        y = torch.einsum('pABji,...pBji->...Aji', J.stencil, windows)
        if self.aux == 1:
            y = y + J.col_P * P[..., None, None, None]
        # integral condition replaces the last q row
        if self.use_intcond_q:
            icq = torch.sum(self._ic_coeff * fields[..., QQ, :, :],
                            dim=(-2, -1))
            y[..., QQ, m - 1, n - 1] = icq
        if self.aux == 1:
            yP = torch.sum(J.prow_q * fields[..., QQ, :, :], dim=(-2, -1)) \
                + J.prow_P * P
        else:
            yP = torch.zeros_like(P)
        return self.join(y, yP)

    def _forcing_fn(self, x, par, sst, sit, msi, Ooa, Os):
        """(AtmosLocal.C:871-985 forcing)"""
        comb, sunp, lonf = par[P_COMB], par[P_SUNP], par[P_LONF]
        latf, albf = par[P_LATF], par[P_ALBF]
        nuq = self._nuq(par)
        ocean_srf, land_srf = self._ocean_srf, self._land_srf
        fields, P = self.split(x)
        Ta, A = fields[TT], fields[AA]

        QSW = (self.As * self._leg_j) * (1 - self.a0)
        # temperature forcing
        f_land = comb * sunp * (Os * self._leg_j) * (1 - self.a0) / Ooa \
            + comb * (sunp * QSW - lonf * self.amua)
        Ts = sst + msi * (sit - sst + self.t0i - self.t0o)
        f_ocean = Ts + comb * (sunp * QSW - lonf * self.amua) \
            + comb * latf * self.lvscale * self._pdist * self.Po0
        fT = land_srf * f_land + ocean_srf * f_ocean

        # humidity forcing
        Eo = (self.tdim / self.qdim) * self.dqso * sst
        Ei = (self.tdim / self.qdim) * self.dqsi * sit
        fq = ocean_srf * nuq * (Eo + msi * (Ei - Eo + self.Cs))

        # albedo forcing (full nonlinear equation)
        af = self._albedo_switch(A, Ta, P, comb, sunp, Ooa, Os)[0]
        fA = land_srf * (comb * albf * af - A) / self.tauf \
            + ocean_srf * (comb * albf * msi - A) / self.tauc

        frc = torch.stack(torch.broadcast_tensors(fT, fq, fA))
        if self.use_intcond_q:
            frc[QQ, self.m - 1, self.n - 1] = 0.0
        return frc

    def _rhs_fn(self, x, par, sst, sit, msi, Ooa, Os):
        """(AtmosLocal.C:782-860 computeRHS + Atmosphere.C:266-391 incl.
        the aux row)"""
        m, n = self.m, self.n
        J = self._jac_fn(x, par, sst, sit, msi, Ooa, Os)
        frc = self._forcing_fn(x, par, sst, sit, msi, Ooa, Os)
        yf, _ = self.split(self._matvec(J, x))
        fields, P = self.split(x)
        F = torch.zeros((NUN, m, n), dtype=x.dtype, device=x.device)
        F[TT] = yf[TT] + frc[TT]
        F[QQ] = yf[QQ] + frc[QQ]
        # albedo rows: forcing only (nonlinear, AtmosLocal.C:824)
        F[AA] = frc[AA]
        if self.use_intcond_q:
            F[QQ, m - 1, n - 1] = yf[QQ, m - 1, n - 1]

        if self.aux == 1:
            # P-row: -P - qInt + sstInt + MCsInt (Atmosphere.C:338+)
            qInt = torch.sum(self._ic_coeff * fields[QQ]) / self.total_area
            tmp = self.dqsi * sit - self.dqso * sst
            sigma = self.dqso * sst + msi * tmp
            sstInt = torch.sum(self._p_coeff * sigma) / self.total_area \
                * (self.tdim / self.qdim)
            MCsInt = torch.sum(self._p_coeff * msi) * self.Cs \
                / self.total_area
            FP = -P - qInt + sstInt + MCsInt
        else:
            FP = torch.zeros_like(P)
        return self.join(F, FP)

    def _evap_fn(self, x, sst, sit, msi):
        """Dimensional evaporation field (AtmosLocal.C:1042-1078)."""
        fields, _ = self.split(x)
        Eo = (self.tdim / self.qdim) * self.dqso * sst
        Ei = (self.tdim / self.qdim) * self.dqsi * sit
        E = Eo - fields[QQ] + msi * (Ei - Eo + self.Cs)
        return self._ocean_srf * (self.Eo0 + self.eta * self.qdim * E)

    def _precip_fn(self, x):
        """Dimensional precipitation field: the P anomaly distributed
        with pdist (Atmosphere.C:1174-1210)."""
        _, P = self.split(x)
        return self._pdist * (self.Po0 + self.eta * self.qdim * P)

    def _mass_fn(self):
        B = torch.zeros((NUN, self.m, self.n), dtype=F64, device=self.device)
        B[TT] = self.Ai
        B[QQ] = 1.0
        B[AA] = 1.0
        if self.use_intcond_q:
            B[QQ, self.m - 1, self.n - 1] = 0.0
        return self.join(B, torch.zeros((), dtype=F64, device=self.device))

    def dense(self, J: AtmosJac | None = None) -> torch.Tensor:
        """The Jacobian as a dense (dim, dim) matrix: batched matvecs on
        identity columns."""
        J = self.jac if J is None else J
        cols = []
        for s in range(0, self.dim, _DENSE_BATCH):
            e = torch.zeros((min(_DENSE_BATCH, self.dim - s), self.dim),
                            dtype=F64, device=self.device)
            e[:, s:s + e.shape[0]] = torch.eye(e.shape[0], dtype=F64,
                                               device=self.device)
            cols.append(self._matvec(J, e))
        return torch.cat(cols).T

    # ------------------------------------------------------------------
    # Model contract
    # ------------------------------------------------------------------
    def compute_rhs(self):
        self.rhs = self._rhs_fn(self.state, self.par, self.sst, self.sit,
                                self.msi, self.Ooa, self.Os)

    def compute_jacobian(self):
        self.jac = self._jac_fn(self.state, self.par, self.sst, self.sit,
                                self.msi, self.Ooa, self.Os)

    def compute_mass_matrix(self):
        self.diagB = self._mass_fn()

    def add_mass_to_jacobian(self, scale: float) -> None:
        """J += scale * diag(B); a new Jacobian, so the next solve factors
        it again."""
        Bf, BP = self.split(self.diagB)
        st = self.jac.stencil.clone()
        for a in range(NUN):
            st[4, a, a] += scale * Bf[a]
        self.jac = self.jac._replace(stencil=st,
                                     prow_P=self.jac.prow_P + scale * BP)

    def apply_matrix(self, v):
        if self.jac is None:
            self.compute_jacobian()
        return self._matvec(self.jac, v)

    def apply_mass_matrix(self, v):
        if self.diagB is None:
            self.compute_mass_matrix()
        return self.diagB * v

    def solve(self, b):
        """Direct solve with the LU factors of the current Jacobian's
        dense matrix, factored at the first solve after each change of
        the Jacobian."""
        if self.jac is None:
            self.compute_jacobian()
        if self._lu is None or self._lu[0] is not self.jac:
            with log.timer("Atmosphere: factor"):
                LU, piv = torch.linalg.lu_factor(self.dense())
            self._lu = (self.jac, LU, piv)
        _, LU, piv = self._lu
        self.sol = torch.linalg.lu_solve(LU, piv, b.reshape(-1, 1))[:, 0]
        self.solve_iters = 1
        return self.sol

    # -- external coupling fields (Atmosphere.C synchronize) ----------
    def set_ocean_temperature(self, sst):
        self.sst = torch.as_tensor(sst, dtype=F64, device=self.device)

    def set_seaice_temperature(self, sit):
        self.sit = torch.as_tensor(sit, dtype=F64, device=self.device)

    def set_seaice_mask(self, msi):
        self.msi = torch.as_tensor(msi, dtype=F64, device=self.device)

    def set_ocean_deps(self, Ooa: float, Os: float):
        """Coefficients computed by the ocean's atmos_coef
        (reference getdeps, usrc.F90:201-219)."""
        self.Ooa = float(Ooa)
        self.Os = float(Os)
        self._update_sun()

    def get_evaporation(self):
        return self._evap_fn(self.state, self.sst, self.sit, self.msi)

    def get_precipitation(self):
        return self._precip_fn(self.state)

    def get_comm_pars(self) -> dict:
        """Parameters shared with the ocean/sea ice
        (AtmosLocal.C:537-558 getCommPars)."""
        comb = float(self.par[P_COMB])
        humf = float(self.par[P_HUMF])
        nuq = comb * humf * (self.eta / self.hdimq) \
            * (self.rhoo / self.rhoa) * (self.r0dim / self.udim)
        return dict(tdim=self.tdim, qdim=self.qdim, nuq=nuq,
                    eta=self.eta, dqso=self.dqso, dqsi=self.dqsi,
                    dqdt=nuq * self.tdim / self.qdim * self.dqso,
                    Eo0=self.Eo0, Ei0=self.Ei0, Cs=self.Cs,
                    t0o=self.t0o, t0i=self.t0i, a0=self.a0,
                    da=self.da, tauf=self.tauf, tauc=self.tauc,
                    comb=comb, albf=float(self.par[P_ALBF]))

    # -- idealized initialization (AtmosLocal.C:422-457) --------------
    def idealized(self, precip: float = 0.0):
        m, n = self.m, self.n
        val = np.cos(np.pi * (self.yc[1:m + 1] - self.ymin)
                     / (self.ymax - self.ymin))[:, None] * np.ones((m, n))
        fields = np.zeros((NUN, m, n))
        fields[TT] = val
        fields[QQ] = val * self.tdim * self.dqso / self.qdim
        fields[AA] = self.a0
        self.sst = self._tensor(val)
        self.state = self.join(self._tensor(fields),
                               self._tensor(float(precip)))

    # -- state access --------------------------------------------------
    def get_state(self, mode='C'):
        return self.state

    def set_state(self, x):
        self.state = x

    def get_rhs(self, mode='C'):
        return self.rhs

    def get_solution(self, mode='C'):
        return self.sol

    def set_par(self, name, value):
        if name in PAR_ORDER:
            self.par = self.par.clone()
            self.par[PAR_ORDER.index(name)] = value
        else:
            log.WARNING(f"Atmosphere: unknown parameter '{name}'")

    def get_par(self, name):
        if name in PAR_ORDER:
            return float(self.par[PAR_ORDER.index(name)])
        log.WARNING(f"Atmosphere: unknown parameter '{name}'")
        return 0.0

    def pre_process(self):
        pass

    def post_process(self):
        pass

    def monitor(self):
        return False

    def write_data(self, describe=False):
        if describe:
            return f"{'max(T)':>12}{'max(q)':>12}{'P':>12}"
        fields, P = self.split(self.state)
        return (f"{float(torch.max(fields[TT])):>12.4e}"
                f"{float(torch.max(fields[QQ])):>12.4e}"
                f"{float(P):>12.4e}")
