"""The ocean with its state split over the ranks of a Domain, behind the
model interface ``Continuation`` calls.

The JAX package has no such module: under GSPMD its ``Ocean`` runs
sharded as it is, and the dry run hands a sharded state to it.  Torch has
no GSPMD, so ``ShardedOcean`` stands in for that: it holds this rank's
block of the state, the residual, the Jacobian's stencil tensor and the
solution, and evaluates them with the partitioned residual and Jacobian
and the sharded solve of :mod:`.halo`.  The parameters, the forcing
fields and the configuration stay with a serial ``Ocean`` on every rank,
which is also what writes checkpoints.  Its sums and maxima over the
ranks (``reduce``, ``reduce_max``) are what ``Continuation`` takes for
its norms and inner products.
"""

from __future__ import annotations

import torch

from ..models.ocean import ocean as _ocean
from ..solvers import factory
from ..utils import logging as log
from .halo import (check_method, make_sharded_ops, make_sharded_solve,
                   sharded_deflator)

# Ocean.solve's Mixed refinement (Ocean._solve_mixed_host, _gmres_ir_host)
OCEAN_MIXED = {"inner_tol": _ocean.MIXED_INNER_TOL,
               "stall_limit": _ocean.MIXED_STALL_LIMIT,
               "tail_iters": _ocean.MIXED_TAIL_ITERS}


class ShardedOcean:
    """The serial ``ocean`` (an ``Ocean`` on this rank's device, at the
    starting state) over the ranks of ``domain``.  The solve is
    ``Ocean.solve``'s, on the ranks: the method the ocean's solver
    parameters name, Preconditioning BGS (factored and applied on the
    rank's block, Double or Mixed, with every option of the Preconditioner
    sublist, read by ``factory.bgs_options`` as the serial factory reads
    them) or Columns (local to the rank, Double), on the THCM-row-scaled
    system where the ocean scales, with the Mixed refinement of
    ``Ocean.solve``, at the FGMRES tolerance and iterations, with the
    pressure null modes of the first Jacobian deflated as ``Ocean``
    deflates them.  Another method, or Columns with Mixed, raises
    ValueError naming it here."""

    def __init__(self, ocean, domain):
        sp = ocean.solver_params
        prec = dict(sp.sublist("Preconditioner").items()) \
            if sp.is_sublist("Preconditioner") else {}
        if not prec.get("Method"):
            prec["Method"] = sp.get("Preconditioning")
        params = factory.preconditioner_params(prec)
        self._method = params.get("Method")
        self._precision = sp.get("Precision")
        check_method(self._method, self._precision)
        self._build_opts = self._apply_opts = None
        if self._method == "BGS":
            self._build_opts, self._apply_opts = factory.bgs_options(params)
        self.ocean = ocean
        self.domain = domain
        self.cfg = ocean.cfg
        ops = make_sharded_ops(ocean, domain)
        self._rhs, self._jac = ops["rhs"], ops["jac"]
        self._solve = None
        self.state = domain.shard_state(ocean.state)
        self.rhs = torch.zeros_like(self.state)
        self.sol = torch.zeros_like(self.state)
        self.jac = None
        self.solve_log: list[tuple[int, float]] = []

    # -- sums over the ranks ---------------------------------------------
    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.domain.allreduce(t)

    @property
    def reduce(self):
        return self.domain.reduce

    @property
    def reduce_max(self):
        return self.domain.reduce_max

    # -- the model contract ----------------------------------------------
    def compute_rhs(self) -> None:
        with log.timer("ShardedOcean: compute rhs"):
            self.rhs = self._rhs(self.state, self.ocean.par,
                                 self.ocean.int_correction)

    def compute_jacobian(self) -> None:
        with log.timer("ShardedOcean: compute jacobian"):
            self.jac = self._jac(self.state, self.ocean.par)

    def _solver(self):
        """The sharded solve, made at the first solve: its deflation
        takes the pressure null modes of that Jacobian, as
        ``Ocean._get_deflator`` does."""
        if self._solve is None:
            nullq = sharded_deflator(self.ocean, self.domain, self.jac)
            self._solve = make_sharded_solve(
                self.ocean, self.domain, precision=self._precision,
                preconditioner=self._method, apply_opts=self._apply_opts,
                build_opts=self._build_opts, scale_double=True,
                nullq=nullq, **OCEAN_MIXED)
        return self._solve

    def solve(self, b):
        """Solve J x = b on the ranks; keeps the solution and records the
        solve's iterations and relres beside its tolerance."""
        if self.jac is None:
            self.compute_jacobian()
        sp = self.ocean.solver_params
        tol = sp.get("FGMRES tolerance")
        with log.timer("ShardedOcean: solve"):
            res = self._solver()(self.jac, b, tol,
                                 sp.get("FGMRES iterations"))
        self.sol = res.x
        self.solve_iters = int(res.mv)
        self.solve_relres = float(res.relres)
        self.solve_tol = float(tol)
        self.solve_log.append((self.solve_iters, self.solve_relres))
        log.track_iterations("ShardedOcean: FGMRES iterations",
                             self.solve_iters)
        log.INFO(f"ShardedOcean: FGMRES solve: {self.solve_iters} iters, "
                 f"relres={self.solve_relres:.2e}")
        return res.x

    def get_state(self, mode: str = 'C'):
        return self.state

    def set_state(self, x) -> None:
        self.state = x

    def get_rhs(self, mode: str = 'C'):
        return self.rhs

    def get_solution(self, mode: str = 'C'):
        return self.sol

    def get_par(self, name: str) -> float:
        return self.ocean.get_par(name)

    def set_par(self, name: str, value: float) -> None:
        self.ocean.set_par(name, value)

    def gather_state(self) -> torch.Tensor:
        """The whole state, on every rank (a collective)."""
        return self.domain.gather(self.state)

    # -- hooks -------------------------------------------------------------
    def pre_process(self) -> None:
        self.ocean.pre_process()

    def post_process(self) -> None:
        """``Ocean.post_process`` on rank 0, on the gathered state, where
        the ocean saves states or writes fort.3."""
        p = self.ocean.params
        if p.get("Save state") or p.get("Use legacy fort.3 output"):
            x = self.gather_state()
            if self.domain.rank == 0:
                self.ocean.set_state(x)
                self.ocean.post_process()

    def monitor(self) -> bool:
        return self.ocean.monitor()

    def write_data(self, describe: bool = False) -> str:
        """``Ocean.write_data``'s columns: the state is gathered for
        psi on rank 0, which writes the cdata line; the other ranks return
        columns of the same widths."""
        from ..models.ocean.diagnostics import psi_min_max
        if describe:
            return self.ocean.write_data(True)
        mv = getattr(self, "solve_iters", 0)
        x = self.gather_state()
        if self.domain.rank != 0:
            return f"{mv:>8d}{'':>14}{'':>14}"
        pmax, pmin = psi_min_max(x, self.ocean.grid, self.ocean.landm)
        return f"{mv:>8d}{pmax:>14.5e}{pmin:>14.5e}"
