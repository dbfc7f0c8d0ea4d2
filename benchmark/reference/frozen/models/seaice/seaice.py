"""Thermodynamic sea-ice model (H, Q_tsa, M, T_si + auxiliary gamma)
(PyTorch).

Port of ``iemic_tpu/models/seaice/seaice.py`` (the reference's
src/seaice/SeaIce.C/H): a pointwise algebraic model with four unknowns
per surface cell — thickness anomaly H, heat flux anomaly Q, the mask M
(a tanh switch of H) and the ice surface temperature anomaly T — plus one
auxiliary global integral correction gamma for the E-P-brine flux balance
(SeaIce.C:440-459).  The Jacobian is block-diagonal (4x4 per cell) with
one dense auxiliary row and no feedback column, so the solve is exact:
batched 4x4 inverses plus a scalar back substitution.  dM/dH is in closed
form where the JAX package takes ``jax.grad``.

Every tensor lives on ``device`` in float64.  State layout: flat
(4*n*m + 1,), row = 4*(j*n + i) + XX, gamma last.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import ParameterList
from ...utils import logging as log

F64 = torch.float64
NUN = 4
HH, QQ, MM, TT = 0, 1, 2, 3

PAR_ORDER = ["Combined Forcing", "Solar Forcing", "Latent Heat Forcing",
             "Mask Forcing", "Sensible Heat Forcing"]
(P_COMB, P_SUNP, P_LATF, P_MASKF, P_SHF) = range(5)


def default_seaice_params() -> ParameterList:
    """Defaults from the SeaIce constructor (SeaIce.C:14-120)."""
    p = ParameterList("Sea Ice")
    p.set("Global Grid-Size n", 16)
    p.set("Global Grid-Size m", 16)
    p.set("Periodic", False)
    p.set("Global Bound xmin", 286.0)
    p.set("Global Bound xmax", 350.0)
    p.set("Global Bound ymin", 10.0)
    p.set("Global Bound ymax", 80.0)
    p.set("threshold ice thickness", 0.01)
    p.set("mask switch steepness", 1e-1)
    p.set("background temperature ocean", 15.0)
    p.set("background temperature seaice", -5.0)
    p.set("background temperature atmosphere", 15.0)
    p.set("ocean background salinity s0", 35.0)
    p.set("atmos reference humidity", 2e-3)
    p.set("atmos humidity scale", 1e-3)
    p.set("temperature scale", 1.0)
    p.set("seaice background mask M0", 0)
    p.set("empirical constant", 0.0058)
    p.set("skin friction velocity, ms^{-1}", 0.02)
    p.set("sea water density, kg m^{-3}", 1.024e3)
    p.set("ice density, kg m^{-3}", 0.913e3)
    p.set("atmospheric density, kg m^{-3}", 1.25)
    p.set("sea water heat capacity, W s kg^{-1} K^{-1]", 4.2e3)
    p.set("latent heat of fusion of ice, J kg^{-1}", 3.347e5)
    p.set("latent heat of sublimation of ice, J kg^{-1}", 2.835e6)
    p.set("constant ice conductivity, W m^{-1} K^{-1}", 2.166)
    p.set("freezing temperature sensitivity", -0.0575)
    p.set("c1", 3.8e-3)
    p.set("c2", 21.87)
    p.set("c3", 265.5)
    p.set("c4", 17.67)
    p.set("c5", 243.5)
    p.set("Dalton number", 1.3e-03)
    p.set("mean atmospheric surface wind speed, ms^{-1}", 8.5)
    p.set("reference albedo", 0.3)
    p.set("albedo excursion", 0.5)
    p.set("solar constant", 1360.0)
    p.set("atmospheric absorption coefficient", 0.43)
    p.set("Ch", 1.22e-3)
    p.set("heat capacity", 1000.0)
    for name, v in zip(PAR_ORDER, (0.0, 1.0, 0.0, 1.0, 1.0)):
        p.set(name, v)
    return p


class SeaIce:
    def __init__(self, params: ParameterList | dict | None = None,
                 surfmask: np.ndarray | None = None, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SeaIce: device cuda but no CUDA device "
                               "(pass device=\"cpu\" to run on the CPU)")
        if params is None:
            params = ParameterList("Sea Ice")
        if isinstance(params, dict):
            params = ParameterList("Sea Ice", params)
        params.validate_and_set_defaults(default_seaice_params())
        self.params = params
        g = params.get

        self.n = g("Global Grid-Size n")
        self.m = g("Global Grid-Size m")
        self.periodic = bool(g("Periodic"))
        n, m = self.n, self.m
        self.aux = 1
        self.dim = NUN * n * m + self.aux

        self.xmin = np.deg2rad(g("Global Bound xmin"))
        self.xmax = np.deg2rad(g("Global Bound xmax"))
        self.ymin = np.deg2rad(g("Global Bound ymin"))
        self.ymax = np.deg2rad(g("Global Bound ymax"))
        self.dx = (self.xmax - self.xmin) / n
        self.dy = (self.ymax - self.ymin) / m
        self.y = self.ymin + (np.arange(m, dtype=np.float64) + 0.5) * self.dy

        # physics constants (SeaIce.C:25-85)
        self.taus = g("threshold ice thickness")
        self.epsilon = g("mask switch steepness")
        self.t0o = g("background temperature ocean")
        self.t0i = g("background temperature seaice")
        self.t0a = g("background temperature atmosphere")
        self.s0 = g("ocean background salinity s0")
        self.q0 = g("atmos reference humidity")
        self.qdim = g("atmos humidity scale")
        self.tdim = g("temperature scale")
        self.H0 = self.taus
        self.M0 = g("seaice background mask M0")
        self.ch = g("empirical constant")
        self.utau = g("skin friction velocity, ms^{-1}")
        self.rhoo = g("sea water density, kg m^{-3}")
        self.rhoi = g("ice density, kg m^{-3}")
        self.rhoa = g("atmospheric density, kg m^{-3}")
        self.cpo = g("sea water heat capacity, W s kg^{-1} K^{-1]")
        self.Lf = g("latent heat of fusion of ice, J kg^{-1}")
        self.Ls = g("latent heat of sublimation of ice, J kg^{-1}")
        self.Ic = g("constant ice conductivity, W m^{-1} K^{-1}")
        self.a0 = g("freezing temperature sensitivity")
        self.zeta = self.ch * self.utau * self.rhoo * self.cpo
        self.r0dim = 6.37e+06
        self.udim = 0.1
        c1, c2, c3, c4, c5 = (g("c1"), g("c2"), g("c3"), g("c4"), g("c5"))
        self.ce = g("Dalton number")
        self.uw = g("mean atmospheric surface wind speed, ms^{-1}")
        self.eta = (self.rhoa / self.rhoo) * self.ce * self.uw
        self.albe0 = g("reference albedo")
        self.albed = g("albedo excursion")
        self.sun0 = g("solar constant")
        self.c0 = g("atmospheric absorption coefficient")
        self.Ch = g("Ch")
        self.cpa = g("heat capacity")
        self.muoa = self.rhoa * self.Ch * self.cpa * self.uw

        qsi = c1 * np.exp(c2 * self.t0i / (self.t0i + c3))
        qso = c1 * np.exp(c4 * self.t0o / (self.t0o + c5))
        self.E0i = self.eta * (qsi - self.q0)
        self.E0o = self.eta * (qso - self.q0)
        dqsi = (c1 * c2 * c3) / (self.t0i + c3) ** 2 \
            * np.exp(c2 * self.t0i / (self.t0i + c3))
        self.dEdT = self.eta * self.qdim * self.tdim / self.qdim * dqsi
        self.dEdq = self.eta * self.qdim * -1.0
        self.pQSnd = 1.0        # reset during ocean synchronization
        self.Qvar = self.zeta
        self.Q0 = -100.0

        self.par = self._tensor([g(name) for name in PAR_ORDER])

        # surface mask and integral coefficients (SeaIce.C:1287-1310)
        if surfmask is None:
            surfmask = np.zeros((m, n), dtype=np.int32)
        self.surfmask = np.asarray(surfmask).astype(np.int32)
        ocean = (self.surfmask == 0)
        self.int_coeff = np.where(
            ocean, np.cos(self.y)[:, None] * self.dx * self.dy, 0.0)
        self.total_area = float(self.int_coeff.sum())
        self._ic = self._tensor(self.int_coeff)
        self._swS = self._tensor(
            1.0 - 0.482 * (3.0 * np.sin(self.y) ** 2 - 1.0) / 2.0)[:, None]

        # external fields (anomalies)
        zero = self._tensor(np.zeros((m, n)))
        self.sst = zero
        self.sss = zero
        self.tatm = zero
        self.qatm = zero
        self.patm = zero
        self.albe = zero

        self.state = self._tensor(np.zeros(self.dim))
        self.rhs = torch.zeros_like(self.state)
        self.sol = torch.zeros_like(self.state)
        self.jac = None
        self.diagB = None
        log.INFO(f"SeaIce: initialized {n}x{m} grid, dim={self.dim}, "
                 f"device={self.device}")

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                               device=self.device)

    # -- state helpers -------------------------------------------------
    def split(self, x):
        m, n = self.m, self.n
        f = x[:NUN * m * n].reshape(m, n, NUN).permute(2, 0, 1)
        return f, x[-1]

    def join(self, f, G):
        return torch.cat([f.permute(1, 2, 0).reshape(-1), G.reshape(1)])

    # ------------------------------------------------------------------
    def _freezingT(self, S):
        return self.a0 * (S + self.s0)

    def _iceSurfT(self, Q, H, S):
        """(SeaIce.H:464-466, linearized variant)"""
        return self._freezingT(S) - self.t0i + (
            self.Q0 * self.H0 + self.H0 * self.Qvar * Q
            + self.Q0 * H) / self.Ic

    def _maskFun(self, H):
        return 0.5 * (1.0 + torch.tanh(H / self.epsilon))

    def _dmaskFun(self, H):
        t = torch.tanh(H / self.epsilon)
        return 0.5 * (1.0 - t * t) / self.epsilon

    def _local_fluxes(self, f, sss, sst, qatm, patm):
        """QSos and E-P over sea ice (SeaIce.C:466-500)."""
        Q, T = f[QQ], f[TT]
        QSos = (self.zeta * (self._freezingT(sss) - (sst + self.t0o))
                - (self.Qvar * Q + self.Q0)) / self.rhoo / self.Lf
        EmiP = self.E0i + self.dEdT * T + self.dEdq * qatm - patm
        return QSos, EmiP

    def _rhs_fn(self, x, par, sst, sss, tatm, qatm, patm, albe, pQSnd):
        """(SeaIce.C:334-465)"""
        comb, sunp, latf = par[P_COMB], par[P_SUNP], par[P_LATF]
        f, G = self.split(x)
        H, Q, M, T = f[HH], f[QQ], f[MM], f[TT]

        Tsi = self._iceSurfT(Q, H, sss)
        FH = (self._freezingT(sss) - sst - self.t0o
              - (self.Q0 / self.zeta + self.Qvar / self.zeta * Q)
              - (self.rhoo * latf * self.Lf / self.zeta)
              * (self.E0i + self.dEdT * T + self.dEdq * qatm))
        QSW = (comb * sunp * self.sun0 / 4.0) * self._swS \
            * ((1.0 - self.albe0) - self.albed * albe) * self.c0
        FQ = (self.Q0 / self.muoa + self.Qvar / self.muoa * Q
              - QSW / self.muoa
              + (T - tatm + (self.t0i - self.t0a))
              + (comb * latf * self.rhoo * self.Ls / self.muoa)
              * (self.E0i + self.dEdT * T + self.dEdq * qatm))
        FM = M - self._maskFun(H)
        FT = Tsi - T

        QSos, EmiP = self._local_fluxes(f, sss, sst, qatm, patm)
        flux_int = torch.sum(self._ic * M * (QSos - EmiP))
        FG = pQSnd * flux_int - G * self.total_area
        return self.join(torch.stack(torch.broadcast_tensors(FH, FQ, FM,
                                                             FT)), FG)

    def _jac_fn(self, x, par, sst, sss, tatm, qatm, patm, albe, pQSnd):
        """Analytic pointwise Jacobian (SeaIce.C:555-695)."""
        m, n = self.m, self.n
        comb, latf = par[P_COMB], par[P_LATF]
        f, G = self.split(x)
        H, M = f[HH], f[MM]

        D = torch.zeros((m, n, NUN, NUN), dtype=x.dtype, device=x.device)
        D[:, :, HH, QQ] = -self.Qvar / self.zeta
        D[:, :, HH, TT] = -(self.rhoo * latf * self.Lf / self.zeta) \
            * self.dEdT
        D[:, :, QQ, QQ] = self.Qvar / self.muoa
        D[:, :, QQ, TT] = 1.0 + comb * latf * self.rhoo * self.Ls \
            / self.muoa * self.dEdT
        D[:, :, MM, HH] = -self._dmaskFun(H)
        D[:, :, MM, MM] = 1.0
        D[:, :, TT, HH] = self.Q0 / self.Ic
        D[:, :, TT, QQ] = self.H0 * self.Qvar / self.Ic
        D[:, :, TT, TT] = -1.0

        # auxiliary gamma row (SeaIce.C:640-670)
        QSos, EmiP = self._local_fluxes(f, sss, sst, qatm, patm)
        icp = self._ic * pQSnd
        Grow = torch.zeros((NUN, m, n), dtype=x.dtype, device=x.device)
        Grow[QQ] = -icp * M * self.Qvar / self.rhoo / self.Lf
        Grow[MM] = icp * (QSos - EmiP)
        Grow[TT] = -icp * M * self.dEdT
        return D, Grow, torch.tensor(-self.total_area, dtype=x.dtype,
                                     device=x.device)

    def _matvec(self, J, v):
        D, Grow, GG = J
        f, G = self.split(v)
        yf = torch.einsum('mnab,bmn->amn', D, f)
        yG = torch.sum(Grow * f) + GG * G
        return self.join(yf, yG)

    def _solve_fn(self, J, b):
        """Exact solve: the fields do not depend on gamma, so the 4x4
        block inverses and a scalar back substitution."""
        D, Grow, GG = J
        bf, bG = self.split(b)
        xf = torch.einsum('mnab,bmn->amn', torch.linalg.inv(D), bf)
        xG = (bG - torch.sum(Grow * xf)) / GG
        return self.join(xf, xG)

    def _mass_fn(self):
        """(SeaIce.C:289-330): only H rows have mass."""
        massH = self.rhoi * self.Lf * self.udim / self.zeta / self.r0dim
        B = torch.zeros((NUN, self.m, self.n), dtype=F64, device=self.device)
        B[HH] = massH
        return self.join(B, torch.zeros((), dtype=F64, device=self.device))

    # ------------------------------------------------------------------
    # Model contract
    # ------------------------------------------------------------------
    def _ext(self):
        return (self.sst, self.sss, self.tatm, self.qatm, self.patm,
                self.albe, self.pQSnd)

    def compute_rhs(self):
        self.rhs = self._rhs_fn(self.state, self.par, *self._ext())

    def compute_jacobian(self):
        self.jac = self._jac_fn(self.state, self.par, *self._ext())

    def compute_mass_matrix(self):
        self.diagB = self._mass_fn()

    def add_mass_to_jacobian(self, scale: float) -> None:
        D, Grow, GG = self.jac
        Bf, BG = self.split(self.diagB)
        D = D.clone()
        for a in range(NUN):
            D[:, :, a, a] += scale * Bf[a]
        self.jac = (D, Grow, GG + scale * BG)

    def apply_matrix(self, v):
        if self.jac is None:
            self.compute_jacobian()
        return self._matvec(self.jac, v)

    def apply_mass_matrix(self, v):
        if self.diagB is None:
            self.compute_mass_matrix()
        return self.diagB * v

    def solve(self, b):
        if self.jac is None:
            self.compute_jacobian()
        self.sol = self._solve_fn(self.jac, b)
        self.solve_iters = 1
        return self.sol

    # -- external fields (SeaIce.C:1125-1228 synchronize) --------------
    def set_ocean_fields(self, sst, sss):
        self.sst = torch.as_tensor(sst, dtype=F64, device=self.device)
        self.sss = torch.as_tensor(sss, dtype=F64, device=self.device)

    def set_atmosphere_fields(self, tatm, qatm, albe, patm):
        self.tatm = torch.as_tensor(tatm, dtype=F64, device=self.device)
        self.qatm = torch.as_tensor(qatm, dtype=F64, device=self.device)
        self.albe = torch.as_tensor(albe, dtype=F64, device=self.device)
        self.patm = torch.as_tensor(patm, dtype=F64, device=self.device)

    def get_mask(self):
        f, _ = self.split(self.state)
        return f[MM]

    def get_surface_temperature(self):
        f, _ = self.split(self.state)
        return f[TT]

    def get_heat_flux(self):
        f, _ = self.split(self.state)
        return f[QQ]

    def get_gamma(self):
        return self.state[-1]

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
            log.WARNING(f"SeaIce: unknown parameter '{name}'")

    def get_par(self, name):
        if name in PAR_ORDER:
            return float(self.par[PAR_ORDER.index(name)])
        log.WARNING(f"SeaIce: unknown parameter '{name}'")
        return 0.0

    def pre_process(self):
        pass

    def post_process(self):
        pass

    def monitor(self):
        return False

    def write_data(self, describe=False):
        if describe:
            return f"{'max(H)':>12}{'max(M)':>12}"
        f, _ = self.split(self.state)
        return (f"{float(torch.max(f[HH])):>12.4e}"
                f"{float(torch.max(f[MM])):>12.4e}")
