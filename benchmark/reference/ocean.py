"""The plain reference of the ocean's residual and Jacobian.

``ReferenceOcean`` is built from the same parameter files the program
reads, and computes on the host, in the dtype it is given:

- F(x, par) = An(x) x + mix - Frc with the integral-condition row;
- the Jacobian's stencil tensor An of shape (27, 6, 6, l, m, n);
- the Jacobian's action with the integral row, scaled as the solve
  scales it;
- THCM's row scale of a stencil tensor, and the pressure null modes that
  the solve deflates.

The assembly is the frozen copy in ``frozen/`` (taken from the port's
``models/ocean`` and the modules it needs); this file repeats the part
of the port's ``Ocean.__init__`` that sets the grid, the mask, the
forcing fields and the parameters, and nothing of its solvers.  It
imports nothing of the program under test.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .frozen.config import read_xml
from .frozen.grid import make_grid
from .frozen.ops.stencil import SS, TT, apply_stencil
from .frozen.models.ocean import (assembly, constants as c,
                                  landmask as lm, scaling)
from .frozen.models.ocean.assembly import CouplingCoefs, ForcingFields
from .frozen.models.ocean.defaults import default_thcm_params
from .frozen.solvers.preconditioner import pressure_null_vectors

F64 = torch.float64


def _cast(obj, dtype):
    """obj with every floating tensor (in NamedTuples, dicts and object
    attributes) cast to dtype."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_cast(v, dtype) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_cast(v, dtype) for v in obj)
    if isinstance(obj, dict):
        return {k: _cast(v, dtype) for k, v in obj.items()}
    if hasattr(obj, "__dict__"):
        for k, v in vars(obj).items():
            setattr(obj, k, _cast(v, dtype))
    return obj


class ReferenceOcean:
    """F, An, J v, the row scale and the null modes of the ocean that
    ``ocean_params.xml`` in workdir describes (its THCM list; the land
    mask is looked up as the port looks it up)."""

    def __init__(self, workdir: str, dtype=F64):
        params = read_xml(os.path.join(workdir, "ocean_params.xml"))
        t = params.sublist("THCM")
        t.validate_and_set_defaults(default_thcm_params())
        if t.get("Time Dependent Forcing") or (
                t.get("Topography") != 1 and not t.get("Read Land Mask")):
            raise ValueError("reference: seasonal forcing and topography "
                             "data are not covered")
        self.dtype = dtype
        data_dir = params.get("Data directory", "")
        n, m, l = (t.get("Global Grid-Size n"), t.get("Global Grid-Size m"),
                   t.get("Global Grid-Size l"))
        self.periodic = bool(t.get("Periodic"))
        self.grid = make_grid(
            n, m, l, xmin_deg=t.get("Global Bound xmin"),
            xmax_deg=t.get("Global Bound xmax"),
            ymin_deg=t.get("Global Bound ymin"),
            ymax_deg=t.get("Global Bound ymax"), hdim=t.get("Depth hdim"),
            qz=t.get("Grid Stretching qz"), periodic=self.periodic)
        self.shape = (6, l, m, n)
        nic, mic = (t.get("Integral row coordinate i"),
                    t.get("Integral row coordinate j"))
        self.nic = n - 1 if nic == -1 else nic
        self.mic = m - 1 if mic == -1 else mic
        self.k = dict(
            tres=t.get("Restoring Temperature Profile"),
            sres=t.get("Restoring Salinity Profile"),
            its=t.get("Levitus S"), ite=t.get("Levitus T"),
            iza=t.get("Wind Forcing Type"),
            coupled_T=t.get("Coupled Temperature"),
            coupled_S=t.get("Coupled Salinity"),
            forcing_type=t.get("Forcing Type"))
        self.int_sign = t.get("Salinity Integral Sign")

        if t.get("Read Land Mask"):
            name = t.get("Land Mask")
            # resolved as the program resolves it from the work directory
            path = os.path.join(workdir, name)
            if not os.path.exists(path):
                path = os.path.join(workdir, data_dir or ".", "mkmask", name)
            raw = lm.read_mask_file(path, self.grid)
        else:
            raw = lm.no_land(self.grid)
        self.landm = lm.finalize_mask(
            raw, self.grid, self.periodic, flat=bool(t.get("Flat Bottom")),
            file_ghosts=bool(t.get("Read Land Mask")))

        fields = {}
        if self.k["iza"] != 2 or self.k["ite"] == 0 or self.k["its"] == 0 \
                or t.get("Levitus Internal T/S") \
                or t.get("Read Salinity Perturbation Mask"):
            raise ValueError("reference: forcing read from data files is "
                             "not covered")
        self.fields = ForcingFields(**fields)
        self.cpl = CouplingCoefs()

        dzne = self.grid.dz * self.grid.dfzT[l - 1]
        self.QTnd = c.R0DIM / (c.UDIM * c.CP0 * c.RHODIM
                               * self.grid.hdim * dzne)
        self.QSnd = c.S0 * c.R0DIM / (c.DELTAS * c.UDIM
                                      * self.grid.hdim * dzne)
        alphaT = t.get("Linear EOS: alpha T")
        self.par0 = torch.as_tensor(np.asarray(c.stpnt(
            self.grid.hdim, self.grid.dz, self.grid.dfzT[l - 1], alphaT,
            t.get("Linear EOS: alpha S"))), dtype=F64)
        for name, val in t.sublist("Starting Parameters").items():
            if not (isinstance(val, float) and np.isnan(val)):
                self.par0 = self.with_par(self.par0, name, val)

        self.rowintcon = (SS, l - 1, self.mic, self.nic)
        self.atoms = assembly.build_linear_atoms(
            self.grid, self.landm, device="cpu",
            ih=t.get("Inhomogeneous Mixing"),
            coriolis_on=t.get("Coriolis Force"))
        self.mixing = None
        if t.get("Mixing") >= 1:
            from .frozen.models.ocean.mixing import Mixing
            self.mixing = Mixing(
                self.grid, self.landm, vmix=t.get("Mixing"),
                tap=t.get("Taper"), rho_mixing=bool(t.get("Rho Mixing")),
                alphaT=alphaT, periodic=self.periodic, device="cpu")
        self.int_coeff = torch.as_tensor(
            np.asarray(assembly.intcond_coeff(self.grid, self.landm)),
            dtype=F64)
        # the program's working precision is f64; a lower one is the
        # control that the check has to refuse
        for name in ("atoms", "mixing", "fields", "cpl", "int_coeff"):
            setattr(self, name, _cast(getattr(self, name), dtype))

    @staticmethod
    def with_par(par: torch.Tensor, name: str, value: float) -> torch.Tensor:
        idx = c.PAR_NAMES[name]
        par = par.clone()
        par[idx] = value
        return par

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(dtype=self.dtype)

    # -- F and An, in the port's parts (the coupled residual and its
    # coupling blocks call them with the coupling fields) --------------
    def _lin(self, par, fields=None, cpl=None):
        k = self.k
        fields = self.fields if fields is None else fields
        return assembly.lin(self.atoms, par, self.grid, tres=k["tres"],
                            sres=k["sres"], coupled_T=k["coupled_T"],
                            coupled_S=k["coupled_S"],
                            cpl=self.cpl if cpl is None else cpl,
                            msi=fields.msi, QTnd=self.QTnd, QSnd=self.QSnd)

    def _frc(self, par, fields=None, cpl=None):
        k = self.k
        frc = assembly.forcing(
            par, self.grid, self.landm, tres=k["tres"], sres=k["sres"],
            its=k["its"], ite=k["ite"], iza=k["iza"],
            coupled_T=k["coupled_T"], coupled_S=k["coupled_S"],
            forcing_type=k["forcing_type"],
            fields=self.fields if fields is None else fields,
            cpl=self.cpl if cpl is None else cpl,
            QTnd=self.QTnd, QSnd=self.QSnd)
        return assembly.boundary_frc_zero(frc, self.landm, self.grid)

    def _nl(self, x, par):
        l, m, n = self.shape[1:]
        zero = torch.zeros((27, 6, 6, l, m, n), dtype=x.dtype,
                           device=x.device)
        return assembly.nlin(zero, x, par, self.grid, self.landm,
                             self.periodic, jac=False)

    def _an_rhs(self, Nl, par, fields=None, cpl=None):
        return assembly.boundaries(self._lin(par, fields, cpl) + Nl,
                                   self.landm, self.grid)

    def _rhs_from_parts(self, An, x, par, fields=None, cpl=None):
        F = apply_stencil(An, x, periodic=self.periodic)
        if self.mixing is not None:
            F[TT:SS + 1] += self.mixing.rhs(x, par)
        F = F - self._frc(par, fields, cpl)
        if self.k["sres"] == 0:
            F[self.rowintcon] = self.int_sign * torch.sum(self.int_coeff * x)
        return F

    def rhs(self, x: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
        """F(x, par), in the reference's dtype."""
        x, par = self.tensor(x), self.tensor(par)
        return self._rhs_from_parts(self._an_rhs(self._nl(x, par), par), x,
                                    par)

    def jacobian(self, x: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
        """The stencil tensor An of J(x, par), in the reference's dtype."""
        x, par = self.tensor(x), self.tensor(par)
        An = assembly.nlin(self._lin(par), x, par, self.grid, self.landm,
                           self.periodic, jac=True)
        if self.mixing is not None:
            An[:, TT:SS + 1, TT:SS + 1] += self.mixing.stencil(x, par)
        return assembly.boundaries(An, self.landm, self.grid)

    # -- what the solve applies ----------------------------------------
    def apply(self, An: torch.Tensor, v: torch.Tensor,
              rint: float = 1.0) -> torch.Tensor:
        """J v with the integral row scaled by rint."""
        y = apply_stencil(An, v, periodic=self.periodic)
        if self.k["sres"] == 0:
            y[self.rowintcon] = rint * self.int_sign * torch.sum(
                self.int_coeff.to(v.dtype) * v)
        return y

    def row_scale(self, An: torch.Tensor) -> torch.Tensor:
        """THCM's row scale R of An, (6, l, m, n)."""
        return scaling.row_col_scaling(An, self.landm)[0]

    def null_basis(self, An: torch.Tensor):
        """Orthonormal (N, k) basis of the pressure null modes that An
        annihilates (the solve's deflator), or None."""
        l, m, n = self.shape[1:]
        scale = float(torch.amax(torch.abs(An)))
        valid = []
        for z in pressure_null_vectors(self.landm, l, m, n,
                                       periodic=self.periodic):
            rz = float(torch.amax(torch.abs(self.apply(An, self.tensor(z)))))
            if rz < 1e-10 * max(scale, 1.0):
                valid.append(z.reshape(-1))
        if not valid:
            return None
        q, _ = np.linalg.qr(np.stack(valid, axis=1))
        return self.tensor(q)

