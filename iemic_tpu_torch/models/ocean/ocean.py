"""The Ocean model: THCM dynamical core behind the Model contract
(PyTorch).

Port of ``iemic_tpu/models/ocean/ocean.py`` (the reference's Ocean +
THCM pair, src/ocean/Ocean.C, THCM.C; Model contract src/utils/Model.H).
The class holds the state, parameter vector, dependency tensor (the
matrix-free Jacobian), forcing and the linear solve, all as tensors on
one ``device`` in float64; the mixed-precision solve runs its inner
Krylov operator in float32 through the Hopper stencil kernel.

In coupled runs ("Coupled Temperature"/"Salinity" 1) the atmosphere and
sea-ice interface fields live in ``fields`` and their coefficients in
``cpl`` (``assembly.CouplingCoefs``), both set by the coupled model's
synchronize; the residual's pieces take them as arguments, so that the
coupled model can push a forward-mode tangent through them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ...config import ParameterList
from ...grid import Grid, make_grid
from ...ops.stencil import SS, TT, apply_stencil, to_flat, from_flat
from ...ops import stencil_hopper
from ...solvers.fgmres import fgmres_flat, fgmres_host
from ...utils import logging as log
from . import assembly, constants as c, landmask as lm
from .assembly import CouplingCoefs, ForcingFields

F64 = torch.float64
# the Mixed solve's refinement (_solve_mixed_host, _gmres_ir_host): a
# refinement sweep's inner f32 solve's tolerance and its stall limit, at
# most MIXED_SWEEPS sweeps, then a GMRES-IR tail of at most
# MIXED_TAIL_ITERS outer iterations.  ShardedOcean's solve takes the same.
MIXED_INNER_TOL = 1e-6
MIXED_STALL_LIMIT = 60
MIXED_SWEEPS = 12
MIXED_TAIL_ITERS = 120


def default_thcm_params() -> ParameterList:
    """THCM defaults (reference THCM.C:2749-2814)."""
    p = ParameterList("THCM")
    p.set("Problem Description", "Unnamed")
    p.set("Global Grid-Size n", 16)
    p.set("Global Grid-Size m", 16)
    p.set("Global Grid-Size l", 16)
    p.set("Global Bound xmin", 286.0)
    p.set("Global Bound xmax", 350.0)
    p.set("Global Bound ymin", 10.0)
    p.set("Global Bound ymax", 74.0)
    p.set("Periodic", False)
    p.set("Depth hdim", 4000.0)
    p.set("Grid Stretching qz", 1.0)
    p.set("Topography", 1)
    p.set("Topography Data", "")
    p.set("Flat Bottom", False)
    p.set("Compute salinity integral", True)
    p.set("Read Land Mask", False)
    p.set("Land Mask", "no_mask_specified")
    p.set("Inhomogeneous Mixing", 0)
    p.set("Mixing", 1)
    p.set("Rho Mixing", True)
    p.set("Taper", 1)
    p.set("Linear EOS: alpha T", 1.0e-4)
    p.set("Linear EOS: alpha S", 7.6e-4)
    p.set("Restoring Temperature Profile", 1)
    p.set("Restoring Salinity Profile", 1)
    p.set("Local SRES Only", False)
    p.set("Salinity Integral Sign", -1)
    p.set("Levitus T", 1)
    p.set("Levitus S", 1)
    p.set("Levitus Internal T/S", False)
    p.set("Coupled Temperature", 0)
    p.set("Coupled Salinity", 0)
    p.set("Coupled Sea Ice Mask", 1)
    p.set("Fix Pressure Points", False)
    p.set("Coriolis Force", 1)
    p.set("Forcing Type", 0)
    p.set("Read Salinity Perturbation Mask", False)
    p.set("Salinity Perturbation Mask", "no_mask_specified")
    p.set("Wind Forcing Type", 2)
    p.set("Wind Forcing Data", "wind/trtau.dat")
    p.set("Temperature Forcing Data", "levitus/new/t00an1")
    p.set("Salinity Forcing Data", "levitus/new/s00an1")
    p.set("Time Dependent Forcing", False)
    p.set("Seasonal Forcing", 1.0)
    p.set("Seasonal Forcing (Wind)", 1.0)
    p.set("Seasonal Forcing (Temperature)", 1.0)
    p.set("Seasonal Forcing (Salinity)", 1.0)
    p.set("Integral row coordinate i", -1)
    p.set("Integral row coordinate j", -1)
    p.set("Scaling", "THCM")
    sp = ParameterList("Starting Parameters")
    for name in c.PAR_NAMES:
        sp.set(name, float("nan"))
    p.set("Starting Parameters", sp)
    return p


def default_ocean_params() -> ParameterList:
    p = ParameterList("Ocean")
    p.set("Load state", False)
    p.set("Save state", False)
    p.set("Input file", "ocean_input.h5")
    p.set("Output file", "ocean_output.h5")
    p.set("Save mask", True)
    p.set("Load mask", True)
    p.set("Store everything", False)
    p.set("Save frequency", 0)
    p.set("Use legacy fort.3 output", False)
    p.set("Save salinity flux", False)
    p.set("Save temperature flux", False)
    p.set("Max mask fixes", 5)
    p.set("Analyze Jacobian", False)
    p.set("Data directory", "")
    p.set("THCM", default_thcm_params())
    return p


def default_solver_params() -> ParameterList:
    p = ParameterList("solver")
    p.set("FGMRES tolerance", 1e-4)
    p.set("FGMRES iterations", 200)
    p.set("FGMRES restarts", 0)
    p.set("FGMRES output", 10)
    p.set("FGMRES explicit residual test", False)
    p.set("Preconditioning", "BGS")
    p.set("Precision", "Mixed")
    # f32 Krylov-loop matvec: "auto" launches the Hopper kernel on a CUDA
    # tensor and uses its plain version on a CPU tensor; "xla" asks for
    # the plain PyTorch version explicitly
    p.set("Matvec kernel", "auto")
    from ...solvers.factory import default_prec_params
    pp = ParameterList("Preconditioner")
    for k, v in default_prec_params().items():
        pp.set(k, "" if k == "Method" else v)
    p.set("Preconditioner", pp)
    return p


@dataclass
class OceanConfig:
    """Static configuration distilled from the parameter lists."""
    n: int
    m: int
    l: int
    periodic: bool
    tres: int
    sres: int
    its: int
    ite: int
    iza: int
    coupled_T: int
    coupled_S: int
    forcing_type: int
    coriolis_on: int
    ih: int
    vmix: int
    rho_mixing: bool
    tap: int
    int_sign: int
    fix_pressure_points: bool
    scaling: str
    nic: int            # integral condition cell i (0-based)
    mic: int            # integral condition cell j (0-based)


def _to_dtype(obj, dtype, memo=None):
    """Cast every floating tensor of a factor tree (NamedTuples, tuples,
    lists, dicts) to dtype, a tensor the tree holds twice (ATS and its
    multigrid's finest level) once; other leaves are kept."""
    memo = {} if memo is None else memo
    if isinstance(obj, torch.Tensor):
        if not obj.is_floating_point():
            return obj
        if id(obj) not in memo:
            memo[id(obj)] = obj.to(dtype)
        return memo[id(obj)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_dtype(v, dtype, memo) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_dtype(v, dtype, memo) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_dtype(v, dtype, memo) for k, v in obj.items()}
    return obj


class Ocean:
    """Ocean model implementing the Model contract."""

    def __init__(self, params: ParameterList | dict | None = None,
                 solver_params: ParameterList | dict | None = None,
                 data_dir: str | None = None, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Ocean: device cuda but no CUDA device "
                               "(pass device=\"cpu\" to run on the CPU)")
        if params is None:
            params = ParameterList("Ocean")
        if isinstance(params, dict):
            params = ParameterList("Ocean", params)
        params.validate_and_set_defaults(default_ocean_params())
        self.params = params

        if solver_params is None:
            solver_params = ParameterList("solver")
        if isinstance(solver_params, dict):
            solver_params = ParameterList("solver", solver_params)
        solver_params.validate_and_set_defaults(default_solver_params())
        self.solver_params = solver_params
        if data_dir is None and params.get("Data directory"):
            data_dir = params.get("Data directory")
        self._data_dir = data_dir

        t = params.sublist("THCM")
        n = t.get("Global Grid-Size n")
        m = t.get("Global Grid-Size m")
        l = t.get("Global Grid-Size l")
        periodic = bool(t.get("Periodic"))
        self.grid: Grid = make_grid(
            n, m, l,
            xmin_deg=t.get("Global Bound xmin"),
            xmax_deg=t.get("Global Bound xmax"),
            ymin_deg=t.get("Global Bound ymin"),
            ymax_deg=t.get("Global Bound ymax"),
            hdim=t.get("Depth hdim"), qz=t.get("Grid Stretching qz"),
            periodic=periodic)

        nic = t.get("Integral row coordinate i")
        mic = t.get("Integral row coordinate j")
        self.cfg = OceanConfig(
            n=n, m=m, l=l, periodic=periodic,
            tres=t.get("Restoring Temperature Profile"),
            sres=t.get("Restoring Salinity Profile"),
            its=t.get("Levitus S"), ite=t.get("Levitus T"),
            iza=t.get("Wind Forcing Type"),
            coupled_T=t.get("Coupled Temperature"),
            coupled_S=t.get("Coupled Salinity"),
            forcing_type=t.get("Forcing Type"),
            coriolis_on=t.get("Coriolis Force"),
            ih=t.get("Inhomogeneous Mixing"),
            vmix=t.get("Mixing"),
            rho_mixing=bool(t.get("Rho Mixing")),
            tap=t.get("Taper"),
            int_sign=t.get("Salinity Integral Sign"),
            fix_pressure_points=bool(t.get("Fix Pressure Points")),
            scaling=t.get("Scaling"),
            nic=(n - 1 if nic == -1 else nic),
            mic=(m - 1 if mic == -1 else mic))
        cfg = self.cfg

        # ---- land mask ----------------------------------------------
        itopo = t.get("Topography")
        if t.get("Read Land Mask"):
            mask_file = t.get("Land Mask")
            path = mask_file if os.path.exists(mask_file) else \
                os.path.join(data_dir or ".", "mkmask", mask_file)
            raw = lm.read_mask_file(path, self.grid)
        elif itopo == 0:
            tf = t.get("Topography Data", "")
            path = tf if os.path.exists(tf) else \
                os.path.join(data_dir or ".", tf)
            if not tf or not os.path.exists(path):
                raise ValueError(
                    "Topography 0 without 'Read Land Mask' needs "
                    "'Topography Data' (an (m, n) .npy depth field)")
            raw = lm.depth_to_land(np.load(path), self.grid)
        elif itopo == 1:
            raw = lm.no_land(self.grid)
        elif itopo == 2:
            raw = lm.miocene(self.grid)
        else:
            raise ValueError(f"Topography option {itopo}: the options "
                             "are 0, 1 and 2")
        self.landm = lm.finalize_mask(
            raw, self.grid, periodic, flat=bool(t.get("Flat Bottom")),
            file_ghosts=bool(t.get("Read Land Mask")))

        # ---- forcing fields -----------------------------------------
        self.fields = ForcingFields(**self._read_forcing_fields(t, data_dir))
        self.cpl = CouplingCoefs()
        self._time = 0.0
        self.monthly_forcing = self._make_monthly_forcing() \
            if t.get("Time Dependent Forcing") else None

        dzne = self.grid.dz * self.grid.dfzT[l - 1]
        self.QTnd = c.R0DIM / (c.UDIM * c.CP0 * c.RHODIM
                               * self.grid.hdim * dzne)
        self.QSnd = c.S0 * c.R0DIM / (c.DELTAS * c.UDIM
                                      * self.grid.hdim * dzne)

        self._alphaT = t.get("Linear EOS: alpha T")
        self.par = self._tensor(c.stpnt(
            self.grid.hdim, self.grid.dz, self.grid.dfzT[l - 1],
            self._alphaT, t.get("Linear EOS: alpha S")))
        for name, val in t.sublist("Starting Parameters").items():
            if not (isinstance(val, float) and np.isnan(val)):
                self.set_par(name, val)

        self.int_correction = 0.0
        self.rowintcon = (SS, l - 1, cfg.mic, cfg.nic)  # field index

        self.state = torch.zeros((6, l, m, n), dtype=F64,
                                 device=self.device)
        self.rhs = torch.zeros_like(self.state)
        self.sol = torch.zeros_like(self.state)
        self.solve_log: list[tuple[int, float]] = []
        self._setup_mask_operators()
        if params.get("Load state"):
            self.load_state_from_file()
        log.INFO(f"Ocean: initialized {n}x{m}x{l} grid, "
                 f"periodic={periodic}, ndim={self.grid.ndim}, "
                 f"device={self.device}")

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=F64, device=self.device)

    def _read_forcing_fields(self, t: ParameterList, data_dir) -> dict:
        """Data-driven forcing fields (levitus.F90, windfit, the salinity
        perturbation mask), as tensors on the device."""
        from . import forcing_data as fd
        cfg = self.cfg
        fields = {}
        if t.get("Read Salinity Perturbation Mask"):
            spath = t.get("Salinity Perturbation Mask")
            if os.path.exists(spath):
                fields["spert"] = lm.read_spert_mask(spath, self.grid,
                                                     self.landm)

        def _data_path(key):
            p = t.get(key)
            if p and os.path.exists(p):
                return p
            if p and data_dir and os.path.exists(os.path.join(data_dir, p)):
                return os.path.join(data_dir, p)
            return None

        if cfg.ite == 0:
            p = _data_path("Temperature Forcing Data")
            if p:
                fields["tatm"] = fd.levitus_surface(p, self.grid,
                                                    self.landm, "TEMP")
        if cfg.its == 0:
            p = _data_path("Salinity Forcing Data")
            if p:
                fields["emip"] = fd.levitus_surface(p, self.grid,
                                                    self.landm, "SALT")
        if cfg.iza != 2:
            p = _data_path("Wind Forcing Data")
            if p:
                fields["taux"], fields["tauy"] = fd.windfit(p, self.grid)
        if t.get("Levitus Internal T/S"):
            pt = _data_path("Temperature Forcing Data")
            ps = _data_path("Salinity Forcing Data")
            if pt and ps:
                fields["internal_temp"] = fd.levitus_internal(
                    pt, self.grid, self.landm, "TEMP")
                fields["internal_salt"] = fd.levitus_internal(
                    ps, self.grid, self.landm, "SALT")
        return {k: self._tensor(v) for k, v in fields.items()}

    def _make_monthly_forcing(self):
        """Seasonal forcing (m_monthly, monthly.F90 init:24-55): annual
        means from the data-driven fields on the host; the monthly slices
        default to the annual mean and are installed afterwards
        (``monthly_forcing.mtaux = ...``, like THCM.C:2591).  The
        idealized profiles are regenerated inside ``forcing``."""
        from .forcing_data import MonthlyForcing
        f = self.fields

        def host(v):
            return None if v is None else v.cpu().numpy()

        def annual(v):
            return host(v) if v is not None else \
                np.zeros((self.cfg.m, self.cfg.n))

        return MonthlyForcing(
            ataux=annual(f.taux), atauy=annual(f.tauy),
            atatm=annual(f.tatm), aemip=annual(f.emip),
            atemp=host(f.internal_temp), asalt=host(f.internal_salt))

    def _setup_mask_operators(self) -> None:
        """Build every operator that depends on the land mask: linear
        atoms, mixing, integral condition, preconditioner closures."""
        cfg = self.cfg
        self.atoms = assembly.build_linear_atoms(
            self.grid, self.landm, device=self.device, ih=cfg.ih,
            coriolis_on=cfg.coriolis_on)
        self.mixing = None
        if cfg.vmix >= 1:
            from .mixing import Mixing
            self.mixing = Mixing(
                self.grid, self.landm, vmix=cfg.vmix, tap=cfg.tap,
                rho_mixing=cfg.rho_mixing, alphaT=self._alphaT,
                periodic=cfg.periodic, device=self.device)
        self.int_coeff = self._tensor(
            assembly.intcond_coeff(self.grid, self.landm))
        if cfg.sres == 0 and \
                self.landm[cfg.l, cfg.mic + 1, cfg.nic + 1] != 0:
            raise RuntimeError("Integral row coordinates give a land point")
        self.jac = None
        self.diagB = None
        self._deflator = None
        self._build_solver()

    # ------------------------------------------------------------------
    # residual, Jacobian, operator
    # ------------------------------------------------------------------
    def _forcing(self, par: torch.Tensor, fields=None, cpl=None
                 ) -> torch.Tensor:
        cfg = self.cfg
        return assembly.forcing(
            par, self.grid, self.landm, tres=cfg.tres, sres=cfg.sres,
            its=cfg.its, ite=cfg.ite, iza=cfg.iza,
            coupled_T=cfg.coupled_T, coupled_S=cfg.coupled_S,
            forcing_type=cfg.forcing_type,
            fields=self.fields if fields is None else fields,
            cpl=self.cpl if cpl is None else cpl,
            QTnd=self.QTnd, QSnd=self.QSnd)

    def _frc(self, par: torch.Tensor, fields=None, cpl=None) -> torch.Tensor:
        return assembly.boundary_frc_zero(self._forcing(par, fields, cpl),
                                          self.landm, self.grid)

    def _lin(self, par: torch.Tensor, fields=None, cpl=None) -> torch.Tensor:
        cfg = self.cfg
        fields = self.fields if fields is None else fields
        return assembly.lin(self.atoms, par, self.grid, tres=cfg.tres,
                            sres=cfg.sres, coupled_T=cfg.coupled_T,
                            coupled_S=cfg.coupled_S,
                            cpl=self.cpl if cpl is None else cpl,
                            msi=fields.msi, QTnd=self.QTnd, QSnd=self.QSnd)

    def _int_row(self, y: torch.Tensor, v: torch.Tensor,
                 scale=1.0) -> torch.Tensor:
        """Integral-condition row replacement (THCM::intcond_S,
        THCM.C:2121-2196), scaled by the row factor; in v's dtype."""
        if self.cfg.sres != 0:
            return y
        intval = torch.sum(self.int_coeff.to(v.dtype) * v)
        y[self.rowintcon] = scale * self.cfg.int_sign * intval
        return y

    def _nl(self, x: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
        """The additive nonlinear (advective, EOS) tensor of the residual:
        it does not depend on the coupling fields, so the coupled model
        keeps it per Jacobian for its coupling blocks."""
        cfg = self.cfg
        zero = torch.zeros((27, 6, 6, cfg.l, cfg.m, cfg.n), dtype=x.dtype,
                           device=x.device)
        return assembly.nlin(zero, x, par, self.grid, self.landm,
                             cfg.periodic, jac=False)

    def _an_rhs(self, Nl: torch.Tensor, par: torch.Tensor, fields=None,
                cpl=None) -> torch.Tensor:
        """The residual's stencil tensor An(x), from its nonlinear part."""
        return assembly.boundaries(self._lin(par, fields, cpl) + Nl,
                                   self.landm, self.grid)

    def _rhs_from_parts(self, An: torch.Tensor, x: torch.Tensor,
                        par: torch.Tensor, fields=None,
                        cpl=None) -> torch.Tensor:
        """F = An x + mix - Frc with the integral-condition row."""
        cfg = self.cfg
        F = apply_stencil(An, x, periodic=cfg.periodic)
        if self.mixing is not None:
            F[TT:SS + 1] += self.mixing.rhs(x, par)
        F = F - self._frc(par, fields, cpl)
        if cfg.sres == 0:
            intval = torch.sum(self.int_coeff * x)
            F[self.rowintcon] = cfg.int_sign * (intval
                                                - self.int_correction)
        return F

    def _rhs(self, x: torch.Tensor, par: torch.Tensor, fields=None,
             cpl=None) -> torch.Tensor:
        """Ocean-convention residual F(x) = An(x) x + mix - Frc, with the
        integral-condition row (THCM rhs negated, THCM.C:1000-1035)."""
        return self._rhs_from_parts(
            self._an_rhs(self._nl(x, par), par, fields, cpl), x, par,
            fields, cpl)

    def _jacobian(self, x: torch.Tensor, par: torch.Tensor, fields=None,
                  cpl=None) -> torch.Tensor:
        cfg = self.cfg
        An = assembly.nlin(self._lin(par, fields, cpl), x, par, self.grid,
                           self.landm, cfg.periodic, jac=True)
        if self.mixing is not None:
            # inserted before boundary handling, like vmix_jac in the
            # reference's matrix() (usrc.F90:472-492)
            An[:, TT:SS + 1, TT:SS + 1] += self.mixing.stencil(x, par)
        return assembly.boundaries(An, self.landm, self.grid)

    def _apply(self, An: torch.Tensor, v: torch.Tensor,
               scale=1.0) -> torch.Tensor:
        """Jacobian action with the (scaled) integral-condition row."""
        return self._int_row(apply_stencil(An, v, periodic=self.cfg.periodic),
                             v, scale)

    def _build_solver(self) -> None:
        cfg = self.cfg
        sp = self.solver_params
        self._precision = sp.get("Precision", "Mixed")
        self._maxiter = sp.get("FGMRES iterations")
        self._deflator = None
        self._prec_for = None
        self._prec_factors = None
        self._prec_factors32 = None
        self._rowscale = None
        self._jac_s = None
        self._jacK32 = None

        from ...solvers import factory as sfactory
        prec_params = dict(sp.sublist("Preconditioner").items()) \
            if sp.is_sublist("Preconditioner") else {}
        if not prec_params.get("Method"):
            prec_params["Method"] = sp.get("Preconditioning")

        def _int_row_provider():
            if cfg.sres != 0:
                return None
            return (self.int_coeff, self.rowintcon,
                    float(self._rint) * cfg.int_sign)

        self._prec_build, self._prec_apply = sfactory.make_preconditioner(
            prec_params, landm=np.asarray(self.landm),
            periodic=cfg.periodic, grid_shape=(cfg.l, cfg.m, cfg.n),
            int_row_provider=_int_row_provider)
        # MILU and Amesos factors live on the host: their solve is the
        # host-driven f64 FGMRES, whatever "Precision" says
        self._prec_host_only = prec_params["Method"] in ("MILU", "Amesos")

        choice = sp.get("Matvec kernel", "auto")
        if choice not in ("auto", "pallas", "xla"):
            raise ValueError(f"Matvec kernel '{choice}'")
        self._use_kernel = choice != "xla"
        if not self._use_kernel:
            log.INFO("Ocean: 'Matvec kernel' = xla: the f32 Krylov matvec "
                     "uses the plain PyTorch stencil, not the Hopper kernel")

    def _mv32(self, v32: torch.Tensor) -> torch.Tensor:
        """The f32 Krylov-loop operator (row-scaled Jacobian)."""
        if self._use_kernel:
            y = stencil_hopper.apply_stencil_prepared(
                self._jacK32, v32, periodic=self.cfg.periodic)
        else:
            y = apply_stencil(self._jacK32, v32, periodic=self.cfg.periodic)
        # the row scale enters the f32 product as an f32 scalar
        return self._int_row(y, v32, self._rint)

    def _mv64(self, v: torch.Tensor, nullq) -> torch.Tensor:
        shape6 = (6, self.cfg.l, self.cfg.m, self.cfg.n)
        y = self._apply(self._jac_s, v.reshape(shape6), self._rint)
        return _proj(y.reshape(-1), nullq)

    # ------------------------------------------------------------------
    # linear solves
    # ------------------------------------------------------------------
    def _inner(self, factors32, r: torch.Tensor, nullq, tol: float):
        """One f32-operator Krylov solve of (R J) dz = r with f64
        Arnoldi; r is the normalized f64 residual."""
        shape6 = (6, self.cfg.l, self.cfg.m, self.cfg.n)
        nullq32 = nullq.float() if nullq is not None else None

        def mv_h(v):
            y = self._mv32(v.float().reshape(shape6))
            return _proj(y.reshape(-1), nullq32).to(r.dtype)

        def pc_h(v):
            z = self._prec_apply(factors32, v.float().reshape(shape6))
            return _proj(z.reshape(-1), nullq32).to(r.dtype)

        res = fgmres_flat(mv_h, pc_h, r, torch.zeros_like(r), tol,
                          self._maxiter, stall_limit=MIXED_STALL_LIMIT)
        return _proj(res.x, nullq), res.iters, res.relres

    def _solve_mixed_host(self, b_s, tol, nullq, factors32,
                          max_refine: int = MIXED_SWEEPS):
        """Mixed-precision solve with host-driven f64 iterative
        refinement, a contraction guard with rollback, and a GMRES-IR
        tail (see the JAX module for the rationale)."""
        flat_b = _proj(b_s.reshape(-1), nullq)
        bn = float(torch.linalg.norm(flat_b))
        target = tol * (bn if bn > 0 else 1.0)
        x = torch.zeros_like(flat_b)
        r = flat_b
        total = 0
        rn = float(torch.linalg.norm(r))
        for _ in range(max_refine):
            if rn <= target:
                break
            dz, its, _ = self._inner(factors32, r / rn, nullq,
                                     MIXED_INNER_TOL)
            total += its
            x_new = x + dz * rn
            r_new = flat_b - self._mv64(x_new, nullq)
            rn_new = float(torch.linalg.norm(r_new))
            if rn_new >= 0.5 * rn:
                # the f32 noise floor: accept only an improvement, then
                # hand over to the monotone outer Krylov
                if rn_new < rn:
                    x, r, rn = x_new, r_new, rn_new
                break
            x, r, rn = x_new, r_new, rn_new
        if rn > target:
            x, more, rn = self._gmres_ir_host(flat_b, x, r, rn, target,
                                              nullq, factors32)
            total += more
        return x.reshape(b_s.shape), total, rn / max(bn, 1e-300)

    def _gmres_ir_host(self, flat_b, x, r, rn, target, nullq, factors32,
                       maxouter: int = MIXED_TAIL_ITERS):
        """GMRES-IR: outer f64 FGMRES on (R J) dx = r preconditioned by
        full-depth f32 inner solves at a loose 1e-2; monotone (a worse
        iterate is rolled back).  Returns inner iterations only."""
        if rn <= 0.0:
            return x, 0, rn
        inner_count = [0]

        def pc(v):
            vn = float(torch.linalg.norm(v))
            if vn == 0.0:
                return v
            dz, its, _ = self._inner(factors32, v / vn, nullq, 1e-2)
            inner_count[0] += its
            return dz * vn

        dx, _ = fgmres_host(lambda v: self._mv64(v, nullq), r, prec=pc,
                            tol=target / rn, maxiter=maxouter)
        x_new = x + dx
        rn_new = float(torch.linalg.norm(flat_b - self._mv64(x_new, nullq)))
        if rn_new >= rn:
            return x, inner_count[0], rn
        return x_new, inner_count[0], rn_new

    def _solve_double(self, b_s, tol, nullq, factors):
        shape = b_s.shape
        flat_b = _proj(b_s.reshape(-1), nullq)

        def pc(v):
            z = self._prec_apply(factors, v.reshape(shape)).reshape(-1)
            return _proj(z, nullq)

        res = fgmres_flat(lambda v: self._mv64(v, nullq), pc, flat_b,
                          torch.zeros_like(flat_b), tol, self._maxiter)
        return _proj(res.x, nullq).reshape(shape), res.iters, res.relres

    def _solve_host_prec(self, b_s, tol, nullq, factors):
        """f64 FGMRES (modified Gram-Schmidt) around a preconditioner
        whose factors live on the host, like the reference's
        AdditiveSchwarz-MRILU path (src/mrilucpp/): the Krylov vectors
        stay on the model's device and each application crosses once."""
        shape = b_s.shape

        def pc(v):
            z = self._prec_apply(factors, v.reshape(shape)).reshape(-1)
            return _proj(z, nullq)

        x, res = fgmres_host(lambda v: self._mv64(v, nullq),
                             _proj(b_s.reshape(-1), nullq), prec=pc,
                             tol=tol, maxiter=self._maxiter)
        return _proj(x, nullq).reshape(shape), res.iters, res.relres

    def _get_prec_factors(self, An=None):
        """Build (or reuse) the preconditioner factors for the stencil
        tensor An (the current Jacobian by default), with THCM row scaling
        (Ocean::scaleProblem).  The row-scaled tensor, its row scale and
        its prepared f32 operator are what the next solve applies."""
        An = self.jac if An is None else An
        if self._prec_for is not An:
            with log.timer("Ocean: build preconditioner"):
                if self.cfg.scaling == "THCM":
                    from . import scaling as _scal
                    R, _ = _scal.row_col_scaling(An, self.landm)
                    self._rowscale = R
                    self._jac_s = An * R[None, :, None]
                    self._rint = float(R[self.rowintcon])
                else:
                    self._rowscale = None
                    self._jac_s = An
                    self._rint = 1.0
                self._prec_factors = self._prec_build(self._jac_s)
                if self._precision == "Mixed" and not self._prec_host_only:
                    # factor in f64, run in f32
                    self._prec_factors32 = _to_dtype(self._prec_factors,
                                                     torch.float32)
                    self._jacK32 = stencil_hopper.prepare(self._jac_s)
                else:
                    self._prec_factors32 = self._prec_factors
                    self._jacK32 = None
                self._prec_for = An
        return self._prec_factors, self._prec_factors32

    def _get_deflator(self):
        """Orthonormal basis (N, k) of the validated pressure null modes
        (deflation replaces the reference's pressure-point fixes,
        Ocean.H:413, THCM.C:2846-2888), or None."""
        if self._deflator is not None:
            return self._deflator if self._deflator is not False else None
        from ...solvers.preconditioner import pressure_null_vectors
        cands = pressure_null_vectors(self.landm, self.cfg.l, self.cfg.m,
                                      self.cfg.n, periodic=self.cfg.periodic)
        scale = float(torch.amax(torch.abs(self.jac)))
        valid = []
        for z in cands:
            rz = float(torch.amax(torch.abs(
                self._apply(self.jac, self._tensor(z)))))
            if rz < 1e-10 * max(scale, 1.0):
                valid.append(z.reshape(-1))
        if not valid:
            self._deflator = False
            return None
        q, _ = np.linalg.qr(np.stack(valid, axis=1))
        self._deflator = self._tensor(q)
        return self._deflator

    # ------------------------------------------------------------------
    # Land mask swapping (reference Ocean::setLandMask/getLandMask,
    # Ocean.C:490-788 — used by the topography homotopy)
    # ------------------------------------------------------------------
    def get_land_mask(self, filename: str,
                      adjust_mask: bool = False) -> np.ndarray:
        """Load a land mask file by name, searched like the constructor
        does (CWD, then <data_dir>/mkmask), as the padded (l+2, m+2, n+2)
        array with the file's ghost cells.  With
        adjust_mask=True the mask is installed and run through the
        analyze-Jacobian mask-fix cycle first (Ocean::getLandMask
        adjustMask path, Ocean.C:490-570), returning the fixed padded
        mask."""
        path = filename if os.path.exists(filename) else \
            os.path.join(self._data_dir or ".", "mkmask", filename)
        raw = lm.read_mask_file(path, self.grid)
        if adjust_mask:
            from . import analysis
            self.set_land_mask(raw, file_ghosts=True)
            self.compute_jacobian()
            analysis.mask_fix_cycle(self)
            return np.asarray(self.landm)
        return raw

    def analyze_jacobian(self) -> int:
        """Singular-row / column-integral analysis of the current
        Jacobian (Ocean::analyzeJacobian1/2, Ocean.C:273-423); returns
        the number of flagged rows."""
        from . import analysis
        f1 = analysis.analyze_jacobian1(self)
        f2 = analysis.analyze_jacobian2(self)
        return int((f1 == 2).sum() + (f2 == 2).sum())

    def integral_checks(self, x=None) -> dict:
        """Salt advection/diffusion conservation integrals
        (integrals.F90:17-89): both must vanish over the ocean."""
        from . import analysis
        adv = analysis.salt_advection(self, x)
        dif = analysis.salt_diffusion(self, x)
        return {"salt advection": float(np.sum(adv)),
                "salt diffusion": float(np.sum(dif))}

    def set_land_mask(self, landm: np.ndarray, *,
                      finalized: bool = False,
                      file_ghosts: bool = False) -> None:
        """Install a new land mask and rebuild everything that depends on
        it: the forcing fields read from files (their land cells),
        atoms, mixing, integral condition, preconditioner closures (with
        the old mask's factors, prepared operator and CUDA graphs
        released) and deflator; jac and diagB are cleared.  Raw (l, m, n)
        masks are finalized first (flood-fill of closed cells, periodic
        seam, reference topo.F90:41-450)."""
        t = self.params.sublist("THCM")
        cfg = self.cfg
        landm = np.asarray(landm)
        if landm.shape == (cfg.l, cfg.m, cfg.n):
            # raw interior mask -> padded (l+2, m+2, n+2) convention;
            # no file ghosts exist, so the periodic seam is generated
            # (open wherever both ends are ocean, topo.F90:314-318)
            full = np.full((cfg.l + 2, cfg.m + 2, cfg.n + 2), 1,
                           dtype=np.int32)
            full[1:cfg.l + 1, 1:cfg.m + 1, 1:cfg.n + 1] = landm
            landm = full
            file_ghosts = False
        if not finalized:
            landm = lm.finalize_mask(landm, self.grid, cfg.periodic,
                                     flat=bool(t.get("Flat Bottom")),
                                     file_ghosts=file_ghosts)
        self.landm = landm
        self._refresh_data_fields()
        self._setup_mask_operators()
        log.INFO("Ocean: land mask replaced; operators rebuilt")

    def _refresh_data_fields(self) -> None:
        """Read the forcing fields that come from files again for the
        current mask (the Levitus interpolation fills land cells, the
        salinity perturbation is zero on land); the monthly forcing's
        annual means follow them.  Fields no file gives are kept."""
        fresh = self._read_forcing_fields(self.params.sublist("THCM"),
                                          self._data_dir)
        if not fresh:
            return
        self.fields = self.fields._replace(**fresh)
        mf = self.monthly_forcing
        if mf is not None:
            annual = self._make_monthly_forcing()
            for k in ("ataux", "atauy", "atatm", "aemip", "atemp", "asalt"):
                setattr(mf, k, getattr(annual, k))

    # ------------------------------------------------------------------
    # Model contract
    # ------------------------------------------------------------------
    def compute_rhs(self) -> None:
        with log.timer("Ocean: compute rhs"):
            self.rhs = self._rhs(self.state, self.par)

    def compute_jacobian(self) -> None:
        with log.timer("Ocean: compute jacobian"):
            self.jac = self._jacobian(self.state, self.par)

    def compute_mass_matrix(self) -> None:
        B = assembly.fillcolB(self.par, self.landm, self.grid,
                              sres=self.cfg.sres)
        if self.cfg.sres == 0:
            B[self.rowintcon] = 0.0
        self.diagB = B

    def add_mass_to_jacobian(self, scale: float) -> None:
        """J += scale * diag(B) on the center block diagonal (reference
        ThetaModel.H:118-146).  The sum is a new tensor: the cached
        preconditioner factors and the prepared f32 operator belong to
        the tensor they were built from (_get_prec_factors), and are
        rebuilt for this one."""
        An = self.jac.clone()
        for a in range(6):
            An[4, a, a] += scale * self.diagB[a]
        self.jac = An

    def apply_matrix(self, v):
        return self._apply(self.jac, v)

    def apply_mass_matrix(self, v):
        if self.diagB is None:
            self.compute_mass_matrix()
        return self.diagB * v

    def solve(self, b):
        """Solve J x = b; keeps the solution (Ocean.C:1060-1151)."""
        if self.jac is None:
            self.compute_jacobian()
        return self._solve_operator(self.jac, b)

    def _solve_operator(self, An, b):
        """Solve An x = b through the configured stack (row scaling,
        Precision, the GMRES-IR tail, the pressure deflator of J): An is
        J or a tensor with J's pressure null modes, such as the topography
        homotopy's blended tensor.  Keeps the solution."""
        tol = self.solver_params.get("FGMRES tolerance")
        nullq = self._get_deflator()
        factors, factors32 = self._get_prec_factors(An)
        b_s = b if self._rowscale is None else b * self._rowscale
        with log.timer("Ocean: solve"):
            if self._prec_host_only:
                x, iters, relres = self._solve_host_prec(b_s, tol, nullq,
                                                         factors)
            elif self._precision == "Mixed":
                x, iters, relres = self._solve_mixed_host(
                    b_s, tol, nullq, factors32)
            else:
                x, iters, relres = self._solve_double(b_s, tol, nullq,
                                                      factors)
        self.sol = x
        self.solve_iters = int(iters)
        self.solve_relres = float(relres)
        self.solve_tol = float(tol)
        self.solve_log.append((self.solve_iters, self.solve_relres))
        log.track_iterations("Ocean: FGMRES iterations", self.solve_iters)
        log.INFO(f"Ocean: FGMRES solve: {self.solve_iters} iters, "
                 f"relres={self.solve_relres:.2e}")
        return x

    def get_state(self, mode: str = 'C'):
        return self.state

    def set_state(self, x) -> None:
        self.state = x

    def get_rhs(self, mode: str = 'C'):
        return self.rhs

    def get_solution(self, mode: str = 'C'):
        return self.sol

    def set_par(self, name: str, value: float) -> None:
        if name == "Time":
            # nondimensional time: with 'Time Dependent Forcing' the
            # forcing fields follow the seasonal cycle (THCM::setParameter
            # param==0, THCM.C:1883-1914)
            self._set_time(value)
            return
        idx = c.PAR_NAMES.get(name)
        if idx is None:
            log.WARNING(f"Ocean: unknown parameter '{name}'")
            return
        self.par = self.par.clone()
        self.par[idx] = value

    def _set_time(self, t: float) -> None:
        """Replace the seasonal forcing fields by their values at time t;
        a negative t resets to the annual means (THCM.C:1904-1913)."""
        self._time = t
        mf = self.monthly_forcing
        if mf is None:
            return
        tpars = self.params.sublist("THCM")
        g = tpars.get("Seasonal Forcing", 1.0)
        gW = g * tpars.get("Seasonal Forcing (Wind)", 1.0)
        gT = g * tpars.get("Seasonal Forcing (Temperature)", 1.0)
        gS = g * tpars.get("Seasonal Forcing (Salinity)", 1.0)
        if t < 0.0:
            t, gW, gT, gS = 0.0, 0.0, 0.0, 0.0
        taux, tauy, tatm, emip = mf.update(t, gW, gT, gS)
        repl = dict(taux=taux, tauy=tauy, tatm=tatm, emip=emip)
        if mf.atemp is not None or mf.mtemp is not None:
            temp, salt = mf.update_internal(t, gT, gS)
            if temp is not None:
                repl["internal_temp"] = temp
            if salt is not None:
                repl["internal_salt"] = salt
        self.fields = self.fields._replace(
            **{k: self._tensor(v) for k, v in repl.items()})

    def get_par(self, name: str) -> float:
        idx = c.PAR_NAMES.get(name)
        if idx is None:
            log.WARNING(f"Ocean: unknown parameter '{name}'")
            return 0.0
        return float(self.par[idx])

    # -- checkpointing (reference Model.H:149-310) ---------------------
    def save_state_to_file(self, filename: str | None = None) -> None:
        from ...utils import hdf5 as h5
        filename = filename or self.params.get("Output file")
        g = self.grid
        grid_meta = dict(
            n=g.n, m=g.m, l=g.l, nun=6, aux=0,
            xmin=g.xmin, xmax=g.xmax, ymin=g.ymin, ymax=g.ymax,
            hdim=g.hdim, x=g.x, y=np.asarray(g.y),
            z=g.z, xu=g.xu, yv=g.yv, zw=g.zw)
        par = self.par.cpu().numpy()
        pars = {c.INT2PAR[i]: float(par[i]) for i in range(c.NPAR)}
        # additional exports (Ocean::additionalExports, Ocean.C:1904)
        extras = {}
        save_sal = self.params.get("Save salinity flux")
        save_tem = self.params.get("Save temperature flux")
        if save_sal or save_tem:
            fx = self.surface_fluxes()
            if save_sal:
                extras["SalinityFlux"] = fx["SalinityFlux"]
            if save_tem:
                extras["TemperatureFlux"] = fx["TemperatureFlux"]
        if self.params.get("Save mask"):
            extras["MaskGlobal"] = np.asarray(self.landm)
        h5.save_state(filename, self.to_flat().cpu().numpy(), pars,
                      grid_meta=grid_meta, extras=extras or None)
        log.INFO(f"Ocean: saved state to {filename}")

    def load_state_from_file(self, filename: str | None = None) -> int:
        from ...utils import hdf5 as h5
        filename = filename or self.params.get("Input file")
        state, pars = h5.load_state(filename)
        if state is None:
            log.WARNING(f"Can't open {filename}, continue with "
                        "trivial state")
            self.state = torch.zeros_like(self.state)
            return 1
        self.state = self.from_flat(self._tensor(state))
        for name, val in pars.items():
            if name in c.PAR_NAMES:
                self.set_par(name, val)
        log.INFO(f"Ocean: loaded state from {filename}")
        return 0

    # -- stochastic forcing (rare-event / stochastic time stepping) ----
    def compute_stochastic_forcing(self):
        """Stochastic salinity-flux forcing map B (reference
        stochastic_forcing, forcing.F90:220-268, assembled by
        THCM::computeForcing, THCM.C:836-935): one white-noise value per
        latitude row scales the freshwater-flux forcing on the surface S
        rows, evaluated with the salinity perturbation SPER off.

        Returns ``apply(pert) -> (6, l, m, n)`` for a noise tensor of m
        values on the model's device, with ``apply.n_noise = m``.  Land
        surface rows and the salinity integral-condition row
        (THCM.C:856-858) are zero."""
        cfg = self.cfg
        if cfg.coupled_S == 1:
            raise RuntimeError("stochastic forcing requires an ocean "
                               "with uncoupled salinity (forcing.F90:238)")
        l = cfg.l
        par0 = self.par.clone()
        par0[c.SPER] = 0.0
        w = self._forcing(par0)[SS, l - 1] \
            * assembly._surf(self.landm, l, cfg.m, cfg.n, par0)
        if cfg.sres == 0:
            w[cfg.mic, cfg.nic] = 0.0
        shape = tuple(self.state.shape)

        def apply(pert: torch.Tensor) -> torch.Tensor:
            G = torch.zeros(shape, dtype=w.dtype, device=w.device)
            G[SS, l - 1] = w * pert[:, None]
            return G

        apply.n_noise = cfg.m
        return apply

    # -- surface flux probes (THCM::getFluxes, probe.F90:89-471) ------
    def surface_fluxes(self) -> dict:
        """Surface heat and freshwater flux fields as (m, n) numpy arrays:
        the total T and S forcing rows of the surface layer
        (forcing.F90:33-120); in coupled mode also their components
        (shortwave, sensible, latent, sea ice), the QToa/QTos and
        QSoa/QSos split of ``assembly.forcing`` (the reference's flux
        probes, probe.F90:89-471, Ocean::additionalExports,
        Ocean.C:1904-1946)."""
        cfg = self.cfg
        Frc = self._frc(self.par)
        out = {"TemperatureFlux": Frc[TT, -1].cpu().numpy(),
               "SalinityFlux": Frc[SS, -1].cpu().numpy()}
        f, cpl = self.fields, self.cpl
        par = self.par.cpu().numpy()
        zeros = np.zeros((cfg.m, cfg.n))

        def fld(name):
            v = getattr(f, name)
            return v.cpu().numpy() if v is not None else zeros

        if cfg.coupled_T == 1:
            qsw = (par[c.COMB] * par[c.SUNP] * fld("suno")
                   * (1.0 - cpl.albe0 - cpl.albed * fld("albe")))
            qsh = cpl.Ooa * fld("tatm")
            qlh = cpl.lvsc * (cpl.eta * cpl.qdim * fld("qatm") - cpl.eo0)
            QToa = qsw + qsh + qlh
            QTos = self.QTnd * cpl.zeta * (cpl.a0 * c.S0 - c.T0)
            out.update(ShortwaveFlux=qsw, SensibleHeatFlux=qsh,
                       LatentHeatFlux=qlh,
                       SeaIceHeatFlux=fld("msi") * (QTos - QToa))
        if cfg.coupled_S == 1:
            pQSnd = par[c.COMB] * par[c.SALT] * self.QSnd
            qsoa = pQSnd * (cpl.eo0 - cpl.eta * cpl.qdim * fld("qatm")
                            - fld("patm"))
            qsos = pQSnd * (cpl.zeta * (cpl.a0 * c.S0 - c.T0)
                            - fld("qsa") / (c.RHODIM * cpl.Lf))
            out.update(OceanAtmosSalFlux=qsoa,
                       OceanSeaIceSalFlux=fld("msi") * (qsos - qsoa))
        return out

    def get_s_corr(self) -> float:
        """Salinity integral correction: the area average of the surface
        salinity flux (THCM::getSCorr via get_salflux,
        probe.F90:200-274), without the sea-ice correction field gsi in
        coupled mode; at a converged coupled state it equals the sea-ice
        gamma (src/tests/test_integrals.C:156-168)."""
        flux = self._frc(self.par)[SS, -1]
        if self.cfg.coupled_S == 1 and self.fields.gsi is not None:
            flux = flux + self.fields.gsi * assembly._surf(
                self.landm, self.cfg.l, self.cfg.m, self.cfg.n, flux)
        return float(assembly.qint(flux, self.grid, self.landm))

    def write_fort3(self, path: str = "fort.3") -> None:
        """Legacy fort.3 text output (inout.F90:55-90 wrtbc): header,
        parameter list, and the solution in the old natural ordering."""
        g = self.grid
        u = self.to_flat().cpu().numpy()
        par = self.par.cpu().numpy()
        npar, nf = len(par), 0
        ndim = u.size
        nskip = int((npar - 1) / 5 + 1) + 1 + nf
        with open(path, "w") as fh:
            fh.write("Version   0%4d%4d%4d%4d%4d%4d%4d%4d%12d%12d\n"
                     % (1, 0, npar, nf, g.n, g.m, g.l, 6, ndim, nskip))
            for i in range(0, npar, 5):
                fh.write(" ".join("%18.10e" % v
                                  for v in par[i:i + 5]) + "\n")
            fh.write("%18.10e %16.8e %16.8e\n" % (0.0, 0.0, 0.0))
            for v in u:
                fh.write("%18.10e\n" % v)
        log.INFO(f"Ocean: wrote legacy output to {path}")

    # -- hooks ---------------------------------------------------------
    def pre_process(self) -> None:
        pass

    def post_process(self) -> None:
        """Save converged states (reference Ocean.C:790-828)."""
        if self.params.get("Save state"):
            self.save_state_to_file()
            if self.params.get("Store everything"):
                self._pp_ctr = getattr(self, "_pp_ctr", 0) + 1
                self.save_state_to_file(self.params.get("Output file")
                                        + f".{self._pp_ctr}")
        if self.params.get("Use legacy fort.3 output"):
            self.write_fort3()

    def monitor(self) -> bool:
        return False

    def write_data(self, describe: bool = False) -> str:
        from .diagnostics import psi_min_max
        if describe:
            return f"{'MV':>8}{'max(psi)':>14}{'min(psi)':>14}"
        mv = getattr(self, 'solve_iters', 0)
        pmax, pmin = psi_min_max(self.state, self.grid, self.landm)
        return f"{mv:>8d}{pmax:>14.5e}{pmin:>14.5e}"

    def to_flat(self, x=None):
        return to_flat(self.state if x is None else x)

    def from_flat(self, v):
        return from_flat(v, self.grid.l, self.grid.m, self.grid.n)


def _proj(v: torch.Tensor, Q) -> torch.Tensor:
    """Project the columns of the orthonormal Q out of v."""
    return v if Q is None else v - Q @ (Q.T @ v)
