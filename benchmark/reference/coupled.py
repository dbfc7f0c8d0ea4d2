"""The plain reference of the coupled model's residual and of a theta
step.

``ReferenceCoupled`` builds, on the host, the frozen copies of the
atmosphere, the sea ice and the coupled model (``frozen/models``) around
an ocean that the reference's own assembly computes (``ocean.py``), from
the same parameter files the program reads.  ``F(x)`` is the coupled
residual at the combined state x (the models synchronised at x, as the
program does before each residual); ``jv(x, v)`` is the coupled
Jacobian's action, from the frozen copy of the models' Jacobians and of
the coupling blocks' assembly.  (A central difference of F is no
measure here: the ocean's truncation error and the sea ice's rounding
part by 1e-5 and more at the step's later iterates, whatever the step.)

``judge_theta`` checks a theta step from what the program produced at
each Newton iterate x_k: the theta residual, the solution dx_k of its
linear system, the program's Jacobian applied to it (J2 dx_k), and the
next iterate.
"""

from __future__ import annotations

import os

import torch

from .frozen.config import read_xml
from .frozen.models.atmosphere.atmosphere import Atmosphere
from .frozen.models.coupled.coupled import CoupledModel
from .frozen.models.ocean import assembly
from .frozen.models.seaice.seaice import SeaIce
from .frozen.utils import logging as frozen_log
from .ocean import ReferenceOcean, _cast

F64 = torch.float64


class Ocean(ReferenceOcean):
    """The reference ocean with the part of the Model contract that the
    coupled model's residual uses (the class name is the coupled model's
    key for its kind)."""

    def __init__(self, workdir: str, dtype=F64):
        super().__init__(workdir, dtype=dtype)
        self.device = torch.device("cpu")
        self.par = self.par0.to(dtype)
        self.state = torch.zeros(self.shape, dtype=dtype)
        self._rhs_val = None
        self.diagB = None

    def _tensor(self, a):
        return self.tensor(a)

    def get_state(self, mode="C"):
        return self.state

    def set_state(self, x):
        self.state = x

    def compute_rhs(self):
        self._rhs_val = self.rhs(self.state, self.par)

    def get_rhs(self, mode="C"):
        return self._rhs_val

    def compute_jacobian(self):
        self.jac = self.jacobian(self.state, self.par)

    def apply_matrix(self, v):
        return self.apply(self.jac, v)

    def compute_mass_matrix(self):
        B = assembly.fillcolB(self.par, self.landm, self.grid,
                              sres=self.k["sres"])
        if self.k["sres"] == 0:
            B[self.rowintcon] = 0.0
        self.diagB = B

    def apply_mass_matrix(self, v):
        if self.diagB is None:
            self.compute_mass_matrix()
        return self.diagB * v


class ReferenceCoupled:
    def __init__(self, workdir: str, dtype=F64):
        def load(name):
            path = os.path.join(workdir, name)
            return read_xml(path) if os.path.exists(path) else None

        frozen_log.set_verbose(False)
        self.ocean = Ocean(workdir, dtype)
        atmos = Atmosphere(load("atmosphere_params.xml"), device="cpu") \
            if load("atmosphere_params.xml") else None
        seaice = SeaIce(load("seaice_params.xml"), device="cpu") \
            if load("seaice_params.xml") else None
        self.model = CoupledModel(self.ocean, atmos, seaice,
                                  params=load("coupledmodel_params.xml"))
        self.dtype = dtype
        if dtype != F64:
            for m in (atmos, seaice):
                if m is not None:
                    _cast(m, dtype)

    def F(self, x: torch.Tensor) -> torch.Tensor:
        m = self.model
        m.set_state(x.to(self.dtype))
        m.compute_rhs()
        return m.get_rhs().to(F64)

    def mass(self, v: torch.Tensor) -> torch.Tensor:
        self.model.compute_mass_matrix()
        return self.model.apply_mass_matrix(v.to(self.dtype)).to(F64)

    def jv(self, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """J(x) v: each model's own Jacobian and the coupling blocks
        (forward-mode derivatives of the frozen cross maps), assembled at
        x, the models synchronised there."""
        m = self.model
        m.set_state(x.to(self.dtype))
        m.compute_jacobian()
        return m.apply_matrix(v.to(self.dtype)).to(F64)

    def ocean_null_basis(self):
        """The ocean's pressure null modes at its current Jacobian, as the
        program's coupled solve deflates them, or None."""
        o = self.ocean
        return o.null_basis(o.jacobian(o.state, o.par))

    def project(self, v: torch.Tensor, Q) -> torch.Tensor:
        if Q is None:
            return v
        no = self.ocean.state.numel()
        vo = v[:no]
        return torch.cat([vo - Q @ (Q.T @ vo), v[no:]])


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b)) / max(float(torch.linalg.norm(b)),
                                                 1e-300)


def _theta_rhs(ref, x, x0, F0, dt, th):
    """The theta residual dt th F(x) + dt (1 - th) F(x0) + M (x0 - x) at
    x, and its scale: the largest sum of its terms' magnitudes, since
    near convergence the terms cancel and the residual itself is no
    measure of their rounding."""
    a, b, c = dt * th * ref.F(x), dt * (1.0 - th) * F0, ref.mass(x0 - x)
    return a + b + c, float(torch.amax(a.abs() + b.abs() + c.abs()))


def _gap(a, b, scale) -> float:
    return float(torch.amax(torch.abs(a - b))) / max(scale, 1e-300)


def judge_theta(workdir: str, step: dict, dtype=F64) -> dict:
    """The compared numbers of one theta step.

    step: ``dt``, ``theta``, the state ``x0`` the step starts from, and
    ``iterates``: for each Newton iterate its state ``x`` and the
    program's theta residual ``F`` there, and where a solve followed,
    its solution ``dx`` and the program's ``Jdx`` at that iterate (J2 dx,
    the Jacobian with the mass matrix); ``final``: the program's state
    after the step."""
    ref = ReferenceCoupled(workdir, dtype)
    dt, th = step["dt"], step["theta"]
    x0 = step["x0"].to(F64)
    F0 = ref.F(x0)

    ref.F(x0)
    Q = ref.ocean_null_basis()
    out = dict(F_gap=0.0, J_gap=0.0, relres=0.0, update_gap=0.0)
    its = step["iterates"]
    for k, it in enumerate(its):
        x = it["x"].to(F64)
        Ft, scale = _theta_rhs(ref, x, x0, F0, dt, th)
        out["F_gap"] = max(out["F_gap"], _gap(it["F"].to(F64), Ft, scale))
        if "dx" not in it:
            continue
        dx = it["dx"].to(F64)
        # J2 dx with J2 = J - M / (theta dt), M's action from the model
        J2dx = ref.jv(x, dx) - ref.mass(dx) / (th * dt)
        out["J_gap"] = max(out["J_gap"], _rel(it["Jdx"].to(F64), J2dx))
        b = ref.project(Ft / (th * dt), Q)
        r = b - ref.project(J2dx, Q)
        out["relres"] = max(out["relres"], float(torch.linalg.norm(r))
                            / max(float(torch.linalg.norm(b)), 1e-300))
        nxt = its[k + 1]["x"].to(F64) if k + 1 < len(its) else \
            step["final"].to(F64)
        out["update_gap"] = max(
            out["update_gap"], float(torch.linalg.norm(nxt - (x - dx)))
            / max(float(torch.linalg.norm(dx)), 1e-300))
    out["final_residual"] = float(torch.linalg.norm(_theta_rhs(
        ref, step["final"].to(F64), x0, F0, dt, th)[0]))
    return out


def control_theta(workdir: str, step: dict, dtype=torch.float32) -> dict:
    """The numbers of the residual and the Jacobian when the reference in
    dtype stands in the program's place, judged by the f64 reference: at
    each of the program's iterates the theta residual computed in dtype,
    and J2 dx with the ocean's stencil tensor (the bulk of J) rounded to
    dtype."""
    ref, low = ReferenceCoupled(workdir), ReferenceCoupled(workdir, dtype)
    dt, th = step["dt"], step["theta"]
    x0 = step["x0"].to(F64)
    F0 = {r: r.F(x0) for r in (ref, low)}
    out = dict(F_gap=0.0, J_gap=0.0)
    for it in step["iterates"]:
        x = it["x"].to(F64)
        hi, scale = _theta_rhs(ref, x, x0, F0[ref], dt, th)
        lo, _ = _theta_rhs(low, x, x0, F0[low], dt, th)
        out["F_gap"] = max(out["F_gap"], _gap(lo, hi, scale))
        if "dx" in it:
            dx = it["dx"].to(F64)
            J2 = ref.jv(x, dx)
            o = ref.ocean
            o.jac = o.jac.to(dtype).to(F64)
            J2_low = ref.model.apply_matrix(dx)
            out["J_gap"] = max(out["J_gap"], _rel(J2_low, J2))
    return out
