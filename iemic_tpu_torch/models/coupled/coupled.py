"""Coupled ocean-atmosphere-seaice model (PyTorch).

Port of ``iemic_tpu/models/coupled/coupled.py`` (the reference's
CoupledModel, src/coupledmodel/CoupledModel.C/H + CouplingBlock.H): the
submodels behind one Model-like interface on a combined state vector,
with

  * pairwise synchronize() pushing interface fields between models
    (Ocean.C:1443-1494, Atmosphere.C:771-793, SeaIce.C:1125-1175)
  * solving schemes 'D'ecoupled / 'Q'uasi / 'C'oupled and block
    preconditioners 'D'iagonal, 'B'ackward / 'C' and 'F'orward / 'G'
    Gauss-Seidel (CoupledModel.C:489-610)
  * a host-driven f64 FGMRES on the combined vector
    (CoupledModel.C:274-435)

The coupling blocks C_ij v_j = d/de F_i(x_i, fields_j(x_j + e v_j)) are
forward-mode derivatives through the synchronization maps
(``torch.autograd.forward_ad``, ``coupling_jvp``), as the JAX package's
``jax.jvp``.  Since every map couples a surface cell only to the same
cell (apart from the global P and gamma), each block is assembled once
per Jacobian from a few such probes and applied as pointwise products
(``coupling_apply``): a forward-mode operation that mixes a dual and a
plain tensor costs a hundred microseconds and more of host time, and an
iteration of the coupled solve applies nine blocks.

The combined state is one flat vector (ocean | atmosphere | seaice, each
in its model's own layout) on the ocean's device, so the continuation,
Newton and theta-stepper drivers work unchanged.  No part of a coupled
solve runs the f32 stencil kernel: the ocean block applies its f64
preconditioner factors and its f64 stencil product.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ...config import ParameterList
from ...solvers.fgmres import fgmres_host
from ...utils import logging as log
from ..atmosphere.atmosphere import PAR_ORDER as ATMOS_PARS
from ..ocean import assembly, constants as oc
from ..seaice.seaice import PAR_ORDER as SEAICE_PARS


def default_coupled_params() -> ParameterList:
    p = ParameterList("CoupledModel")
    p.set("Solving scheme", "C")
    p.set("Preconditioning", "F")
    p.set("Use ocean", True)
    p.set("Use atmosphere", True)
    p.set("Use sea ice", False)
    return p


def _kind(model) -> str:
    return type(model).__name__


def _surface(model) -> tuple[int, int]:
    """(m, n) of the model's surface grid."""
    if _kind(model) == "Ocean":
        return model.grid.m, model.grid.n
    return model.m, model.n


def _cell_layout(model) -> tuple[int, int]:
    """(fields per surface cell, global unknowns) of a model's state: the
    ocean's 6*l slabs (var, k), the atmosphere's T, q, A and P, the sea
    ice's H, Q, M, T and gamma."""
    if _kind(model) == "Ocean":
        return 6 * model.grid.l, 0
    if _kind(model) == "Atmosphere":
        return 3 * model.l, model.aux
    return 4, 1


def _to_cells(model, v):
    """A state-shaped vector as (fields (S, m, n), globals (G,))."""
    S, G = _cell_layout(model)
    m, n = _surface(model)
    if _kind(model) == "Ocean":
        return v.reshape(S, m, n), v.new_zeros((0,))
    flat = v.reshape(-1)
    return flat[:S * m * n].reshape(m, n, S).permute(2, 0, 1), flat[S * m * n:]


def _from_cells(model, cells, glob):
    if _kind(model) == "Ocean":
        return cells.reshape(model.get_state().shape)
    return torch.cat([cells.permute(1, 2, 0).reshape(-1), glob])


class CoupledModel:
    def __init__(self, ocean, atmos=None, seaice=None,
                 params: ParameterList | dict | None = None,
                 solver_params: dict | None = None):
        if params is None:
            params = ParameterList("CoupledModel")
        if isinstance(params, dict):
            params = ParameterList("CoupledModel", params)
        params.validate_and_set_defaults(default_coupled_params())
        self.params = params

        self.solving_scheme = params.get("Solving scheme")
        self.prec_scheme = params.get("Preconditioning")
        self.use_ocean = bool(params.get("Use ocean"))
        self.use_atmos = bool(params.get("Use atmosphere")) \
            and atmos is not None
        self.use_seaice = bool(params.get("Use sea ice")) \
            and seaice is not None

        self.ocean = ocean if self.use_ocean else None
        self.atmos = atmos if self.use_atmos else None
        self.seaice = seaice if self.use_seaice else None
        self.models = [m for m in (self.ocean, self.atmos, self.seaice)
                       if m is not None]
        if not self.models:
            raise ValueError("At least one model should be active")
        self.device = self.models[0].device
        if any(m.device != self.device for m in self.models):
            raise ValueError("the coupled models lie on different devices")

        sp = solver_params or {}
        self.fgmres_tol = sp.get("FGMRES tolerance", 1e-2)
        self.fgmres_iters = sp.get("FGMRES iterations", 200)

        # combined flat layout
        self._shapes = [tuple(m.get_state().shape) for m in self.models]
        self._sizes = [int(np.prod(s)) for s in self._shapes]
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)])
        self.dim = int(self._offsets[-1])

        self.sol = torch.zeros(self.dim, dtype=torch.float64,
                               device=self.device)
        self._ocean_cache = None
        self._blocks = {}
        self.solve_log: list[tuple[int, float]] = []
        self.sync_ctr = 0
        self.synchronize()
        log.INFO(f"CoupledModel: dim={self.dim}, scheme="
                 f"{self.solving_scheme}/{self.prec_scheme}")

    # -- combined vector helpers --------------------------------------
    def split(self, x):
        return tuple(x[self._offsets[i]:self._offsets[i + 1]].reshape(s)
                     for i, s in enumerate(self._shapes))

    def join(self, parts):
        return torch.cat([p.reshape(-1) for p in parts])

    # ------------------------------------------------------------------
    # synchronization (CoupledModel.C:218-235 + per-model synchronize)
    # ------------------------------------------------------------------
    def _ocean_deps(self) -> dict:
        """Coefficients the ocean exports (reference getdeps,
        usrc.F90:201-219, atmos_coef usrc.F90:1183-1223)."""
        o = self.ocean
        muoa = 1.25 * (0.94 * 1.3e-3) * 1000.0 * 8.5   # atm.F90 constants
        Ooa = muoa * o.QTnd
        Os = 1360.0 * 0.43 / 4.0 * o.QTnd
        pQSnd = float(o.par[oc.COMB] * o.par[oc.SALT] * o.QSnd)
        return dict(Ooa=Ooa, Os=Os, pQSnd=pQSnd)

    def synchronize(self):
        self.sync_ctr += 1
        self._blocks = {}
        o, a, s = self.ocean, self.atmos, self.seaice
        deps = self._ocean_deps() if o is not None else \
            dict(Ooa=1.0, Os=1.0, pQSnd=1.0)

        if o is not None and a is not None:
            # Ocean <- Atmosphere (Ocean.C:1443-1473): interface fields
            # + CommPars -> set_atmos_parameters (usrc.F90:237-293)
            cp = a.get_comm_pars()
            fa, P = a.split(a.get_state())
            nus = float(o.par[oc.COMB] * o.par[oc.SALT]) * cp["eta"] \
                * cp["qdim"] * o.QSnd
            lvsc = float(o.par[oc.COMB] * o.par[oc.TEMP]) \
                * oc.RHODIM * oc.LV * o.QTnd
            o.cpl = o.cpl._replace(
                Ooa=deps["Ooa"], eta=cp["eta"], qdim=cp["qdim"],
                dqso=cp["dqso"], eo0=cp["Eo0"], albe0=cp["a0"],
                albed=cp["da"], nus=nus, lvsc=lvsc)
            suno = deps["Os"] * (
                1.0 - 0.482 * (3 * np.sin(o.grid.y) ** 2 - 1.0) / 2.0)
            o.fields = o.fields._replace(
                tatm=fa[0], qatm=fa[1], albe=fa[2],
                patm=P.expand(a.m, a.n),
                suno=o._tensor(suno)[:, None].expand(a.m, a.n))
            # Atmosphere <- Ocean (Atmosphere.C:771-781)
            a.set_ocean_temperature(self._ocean_sst())
            a.set_ocean_deps(deps["Ooa"], deps["Os"])

        if o is not None and s is not None:
            # Ocean <- SeaIce (Ocean.C:1475-1494 + usrc.F90:296-333)
            fi, G = s.split(s.get_state())
            o.cpl = o.cpl._replace(zeta=s.zeta, a0=s.a0, Lf=s.Lf,
                                   qvar=s.Qvar, q0=s.Q0)
            o.fields = o.fields._replace(qsa=fi[1], msi=fi[2],
                                         gsi=G.expand(s.m, s.n))
            # SeaIce <- Ocean (SeaIce.C:1125-1143)
            s.set_ocean_fields(self._ocean_sst(), self._ocean_sss())
            s.pQSnd = deps["pQSnd"]

        if a is not None and s is not None:
            # Atmosphere <- SeaIce (Atmosphere.C:784-793)
            fi, G = s.split(s.get_state())
            a.set_seaice_mask(fi[2])
            a.set_seaice_temperature(fi[3])
            # SeaIce <- Atmosphere (SeaIce.C:1146-1175)
            fa, P = a.split(a.get_state())
            s.set_atmosphere_fields(fa[0], fa[1], fa[2], P.expand(a.m, a.n))
            s.albe0 = a.a0
            s.albed = a.da

    def _ocean_sst(self):
        return self.ocean.get_state()[4, self.ocean.grid.l - 1]

    def _ocean_sss(self):
        return self.ocean.get_state()[5, self.ocean.grid.l - 1]

    # ------------------------------------------------------------------
    # cross-coupling maps, differentiated by forward-mode AD
    # ------------------------------------------------------------------
    def _ocean_aux(self):
        """(nonlinear tensor, residual stencil tensor) of the ocean at
        its state, parameters, fields and coefficients: neither depends
        on the atmosphere's fields, and the nonlinear tensor on none of
        the coupling fields.  Kept while those four are the same
        objects."""
        o = self.ocean
        key = (o.get_state(), o.par, o.fields, o.cpl)
        cache = self._ocean_cache
        if cache is None or any(a is not b for a, b in zip(cache[0], key)):
            Nl = o._nl(o.get_state(), o.par)
            cache = self._ocean_cache = (key, Nl, o._an_rhs(Nl, o.par))
        return cache[1:]

    def _ocean_rhs_of_atmos(self, xo, xa):
        """F_ocean as a function of the atmosphere state: through the
        surface forcing only."""
        o, a = self.ocean, self.atmos
        fa, P = a.split(xa)
        fields = o.fields._replace(tatm=fa[0], qatm=fa[1], albe=fa[2],
                                   patm=P.expand(a.m, a.n))
        return o._rhs_from_parts(self._ocean_aux()[1], xo, o.par, fields)

    def _ocean_rhs_of_seaice(self, xo, xi):
        """F_ocean as a function of the sea-ice state: through the
        forcing and, by the mask, the stencil tensor.  The boundary
        handling is affine in the tensor, so the tangent of the tensor is
        its linear part applied to the tangent of the linear atoms; that
        is exact, and spares forward-mode AD its hundred masked
        updates."""
        o, s = self.ocean, self.seaice
        fi, G = s.split(xi)
        fields = o.fields._replace(qsa=fi[1], msi=fi[2],
                                   gsi=G.expand(s.m, s.n))
        Al, dAl = fwAD.unpack_dual(o._lin(o.par, fields))
        An = assembly.boundaries(Al + self._ocean_aux()[0], o.landm, o.grid)
        if dAl is not None:
            An = fwAD.make_dual(An, assembly.boundaries(
                dAl, o.landm, o.grid, linear_part=True))
        return o._rhs_from_parts(An, xo, o.par, fields)

    def _atmos_rhs_of_ocean(self, xa, xo):
        a = self.atmos
        sst = xo[4, self.ocean.grid.l - 1]
        return a._rhs_fn(xa, a.par, sst, a.sit, a.msi, a.Ooa, a.Os)

    def _atmos_rhs_of_seaice(self, xa, xi):
        a, s = self.atmos, self.seaice
        fi, _ = s.split(xi)
        return a._rhs_fn(xa, a.par, a.sst, fi[3], fi[2], a.Ooa, a.Os)

    def _seaice_rhs_of_ocean(self, xi, xo):
        s = self.seaice
        l = self.ocean.grid.l
        return s._rhs_fn(xi, s.par, xo[4, l - 1], xo[5, l - 1], s.tatm,
                         s.qatm, s.patm, s.albe, s.pQSnd)

    def _seaice_rhs_of_atmos(self, xi, xa):
        s, a = self.seaice, self.atmos
        fa, P = a.split(xa)
        return s._rhs_fn(xi, s.par, s.sst, s.sss, fa[0], fa[1],
                         P.expand(a.m, a.n), fa[2], s.pQSnd)

    _CROSS = {("Ocean", "Atmosphere"): _ocean_rhs_of_atmos,
              ("Ocean", "SeaIce"): _ocean_rhs_of_seaice,
              ("Atmosphere", "Ocean"): _atmos_rhs_of_ocean,
              ("Atmosphere", "SeaIce"): _atmos_rhs_of_seaice,
              ("SeaIce", "Ocean"): _seaice_rhs_of_ocean,
              ("SeaIce", "Atmosphere"): _seaice_rhs_of_atmos}

    def coupling_jvp(self, i, j, v_j):
        """C_ij v_j by forward-mode AD through the cross map: the
        derivative of F_i in the direction v_j of model j's state, at the
        current states; None where model i does not see model j."""
        fn = self._CROSS.get((_kind(self.models[i]), _kind(self.models[j])))
        if fn is None:
            return None
        xi = self.models[i].get_state()
        xj = self.models[j].get_state()
        with fwAD.dual_level():
            dual = fwAD.make_dual(xj, v_j.reshape(xj.shape).to(xj.dtype))
            out = fwAD.unpack_dual(fn(self, xi, dual))
        if out.tangent is None:
            return torch.zeros_like(out.primal)
        return out.tangent

    def _block(self, i, j):
        """The coupling block C_ij assembled at the current states, or
        None: every cross map couples a surface cell of model j only to
        the same cell's rows of model i, apart from the global unknowns
        (the atmosphere's P, the sea ice's gamma) and global rows (their
        equations).  So one forward-mode probe per source field (ones on
        that field), one per source global unknown, and one reverse-mode
        gradient per target global row give the whole block, as the
        reference assembles its CouplingBlock matrices from derivative
        probes (Ocean.C:1538-1746).  Kept until the next synchronize,
        set_state or set_par."""
        if (i, j) in self._blocks:
            return self._blocks[i, j]
        mi, mj = self.models[i], self.models[j]
        fn = self._CROSS.get((_kind(mi), _kind(mj)))
        if fn is None:
            self._blocks[i, j] = None
            return None
        with log.timer("CoupledModel: coupling blocks", sync=True):
            blk = self._blocks[i, j] = self._probe_block(i, j, fn)
        return blk

    def _probe_block(self, i, j, fn):
        """(D, src, cols, rows) of _block's C_ij from its probes."""
        mi, mj = self.models[i], self.models[j]
        xi, xj = mi.get_state(), mj.get_state()
        Sj, Gj = _cell_layout(mj)
        src = self._reads(mj) if _kind(mj) == "Ocean" and \
            _kind(mi) != "Ocean" else list(range(Sj))
        m, n = _surface(mj)

        def probe(cells, glob):
            t = self.coupling_jvp(i, j, _from_cells(mj, cells, glob))
            return _to_cells(mi, t)[0]

        zero_c = xj.new_zeros((Sj, m, n))
        zero_g = xj.new_zeros((Gj,))
        D = []
        for sl in src:
            e = zero_c.clone()
            e[sl] = 1.0
            D.append(probe(e, zero_g))
        cols = None
        if Gj:
            cols = []
            for g in range(Gj):
                e = zero_g.clone()
                e[g] = 1.0
                cols.append(probe(zero_c, e))
            cols = torch.stack(cols)
        rows = None
        if _cell_layout(mi)[1]:
            leaf = xj.detach().clone().requires_grad_(True)
            with torch.enable_grad():
                glob = _to_cells(mi, fn(self, xi, leaf))[1]
                rows = torch.stack([torch.autograd.grad(
                    glob[r], leaf, retain_graph=True)[0].reshape(-1)
                    for r in range(glob.shape[0])])
        return torch.stack(D, dim=1), src, cols, rows

    def _reads(self, ocean):
        """The ocean slabs the atmosphere and sea-ice maps read: surface
        T and S (index var*l + k of the state's (6*l, m, n) view)."""
        l = ocean.grid.l
        return [4 * l + l - 1, 5 * l + l - 1]

    def coupling_apply(self, i, j, v_j):
        """C_ij v_j at the current states (CoupledModel.C:236-259), from
        the block assembled by _block; None where model i does not see
        model j."""
        blk = self._block(i, j)
        if blk is None:
            return None
        D, src, cols, rows = blk
        mi, mj = self.models[i], self.models[j]
        v = v_j.reshape(mj.get_state().shape)
        cells, glob = _to_cells(mj, v)
        y = torch.einsum('rsmn,smn->rmn', D, cells[src])
        if cols is not None:
            y = y + torch.einsum('grmn,g->rmn', cols, glob)
        yg = rows @ v.reshape(-1) if rows is not None \
            else v.new_zeros((0,))
        return _from_cells(mi, y, yg)

    # ------------------------------------------------------------------
    # Model contract
    # ------------------------------------------------------------------
    def compute_rhs(self):
        if self.solving_scheme != "D":
            self.synchronize()
        for m in self.models:
            m.compute_rhs()

    def compute_jacobian(self):
        if self.solving_scheme != "D":
            self.synchronize()
        for m in self.models:
            m.compute_jacobian()

    def compute_mass_matrix(self):
        for m in self.models:
            m.compute_mass_matrix()

    def apply_matrix(self, v):
        """[J1 C12; C21 J2] v (CoupledModel.C:436-472)."""
        parts = self.split(v)
        out = [m.apply_matrix(p) for m, p in zip(self.models, parts)]
        if self.solving_scheme == "C":
            for i in range(len(self.models)):
                for j in range(len(self.models)):
                    if i != j:
                        c = self.coupling_apply(i, j, parts[j])
                        if c is not None:
                            out[i] = out[i] + c
        return self.join(out)

    def apply_mass_matrix(self, v):
        parts = self.split(v)
        return self.join([m.apply_mass_matrix(p)
                          for m, p in zip(self.models, parts)])

    def add_mass_to_jacobian(self, scale):
        for m in self.models:
            m.add_mass_to_jacobian(scale)

    @log.timed("CoupledModel: precon")
    def apply_precon(self, x):
        """Block preconditioner sweep (CoupledModel.C:489-610)."""
        parts = self.split(x)
        nm = len(self.models)
        z = [torch.zeros_like(p) for p in parts]
        if self.prec_scheme == "D" or self.solving_scheme != "C":
            for k in range(nm):
                z[k] = self._model_precon(k, parts[k])
        elif self.prec_scheme in ("B", "C"):
            iters = 2 if self.prec_scheme == "C" else 1
            for it in range(iters):
                for k in range(nm - 1, -1, -1):
                    b = parts[k]
                    for i in range(nm):
                        if i < k and it > 0:
                            sign = 1.0
                        elif i > k:
                            sign = -1.0
                        else:
                            continue
                        c = self.coupling_apply(k, i, z[i])
                        if c is not None:
                            b = b + sign * c
                    if (self.prec_scheme == "C" and it == iters - 1
                            and k == 0):
                        break
                    z[k] = self._model_precon(k, b)
        elif self.prec_scheme in ("F", "G"):
            iters = 2 if self.prec_scheme == "G" else 1
            for it in range(iters):
                for k in range(nm):
                    b = parts[k]
                    for i in range(nm):
                        if i < k:
                            sign = -1.0
                        elif i > k and it > 0:
                            sign = 1.0
                        else:
                            continue
                        c = self.coupling_apply(k, i, z[i])
                        if c is not None:
                            b = b + sign * c
                    z[k] = self._model_precon(k, b)
        else:
            log.WARNING(f"Invalid prec scheme {self.prec_scheme}")
        return self.join(z)

    def _model_precon(self, k, b):
        """Model k's own preconditioner, as the reference's block sweep
        hands the ocean block to its BlockPreconditioner and the
        atmosphere and sea ice to their solves (CoupledModel.C:489-610).
        The ocean applies its f64 factors of the row-scaled Jacobian
        (built once per Jacobian by Ocean._get_prec_factors), as the JAX
        package does: the coupled Krylov solve is f64 throughout, and the
        f32 factors and operator of a Mixed ocean are not used here."""
        m = self.models[k]
        if _kind(m) == "Ocean":
            factors, _ = m._get_prec_factors()
            if m._rowscale is not None:
                b = b * m._rowscale      # the factors see (R J)
            z = m._prec_apply(factors, b)
            q = m._get_deflator()
            if q is not None:
                zf = z.reshape(-1)
                z = (zf - q @ (q.T @ zf)).reshape(z.shape)
            return z
        return m.solve(b)

    def _project_ocean_null(self, v):
        """Project the ocean's pressure null modes (constant +
        checkerboard, THCM::getNullSpace) out of the ocean block of a
        flat coupled vector: the ocean deflates them where the reference
        pins pressure points (THCM.C:2201), and the coupled Krylov solve
        must deflate the same modes."""
        if self.ocean is None:
            return v
        q = self.ocean._get_deflator()
        if q is None:
            return v
        no = int(self._offsets[1])
        vo = v[:no]
        return torch.cat([vo - q @ (q.T @ vo), v[no:]])

    def solve(self, b):
        """Coupled FGMRES (CoupledModel.C:354-433), driven from the host
        like the reference's Belos-on-BelosOp set-up.  Records the
        iterations and the true relative residual of the (projected)
        system, and the tolerance asked."""
        proj = self._project_ocean_null
        flat_b = proj(b.reshape(-1))
        with log.timer("CoupledModel: solve", sync=True):
            x, res = fgmres_host(
                lambda v: proj(self.apply_matrix(v)), flat_b,
                prec=lambda v: proj(self.apply_precon(v)),
                tol=self.fgmres_tol, maxiter=self.fgmres_iters)
            self.sol = proj(x)
            bn = float(log.host(torch.linalg.norm(flat_b)))
            rn = float(log.host(torch.linalg.norm(
                proj(self.apply_matrix(self.sol)) - flat_b)))
        self.solve_iters = int(res.iters)
        self.solve_relres = rn / max(bn, 1e-300)
        self.solve_tol = float(self.fgmres_tol)
        self.solve_log.append((self.solve_iters, self.solve_relres))
        log.track_iterations("CoupledModel: FGMRES iterations...",
                             self.solve_iters)
        log.INFO(f"CoupledModel: FGMRES {self.solve_iters} iters, "
                 f"relres={self.solve_relres:.2e} (estimate "
                 f"{res.relres:.2e}, tolerance {self.fgmres_tol:.1e}) in "
                 f"{log.seconds('CoupledModel: solve'):.3f} s")
        return self.sol

    # -- state access --------------------------------------------------
    def get_state(self, mode='C'):
        return self.join([m.get_state() for m in self.models])

    def set_state(self, x):
        self._blocks = {}
        for m, p in zip(self.models, self.split(x)):
            m.set_state(p.clone())

    def get_rhs(self, mode='C'):
        return self.join([m.get_rhs() for m in self.models])

    def get_solution(self, mode='C'):
        return self.sol

    def set_par(self, name, value):
        """Forward to the submodels that know the parameter
        (CoupledModel::setPar semantics)."""
        self._blocks = {}
        for m in self.models:
            if name in self._par_names(m):
                m.set_par(name, value)

    def get_par(self, name):
        for kind in ("Ocean", "Atmosphere", "SeaIce"):
            for m in self.models:
                if _kind(m) == kind and name in self._par_names(m):
                    return m.get_par(name)
        return 0.0

    @staticmethod
    def _par_names(m):
        return {"Ocean": oc.PAR_NAMES, "Atmosphere": ATMOS_PARS,
                "SeaIce": SEAICE_PARS}[_kind(m)]

    def pre_process(self):
        for m in self.models:
            m.pre_process()

    def post_process(self):
        for m in self.models:
            m.post_process()

    def monitor(self):
        return any(m.monitor() for m in self.models)

    def write_data(self, describe=False):
        return "".join(m.write_data(describe) for m in self.models)
