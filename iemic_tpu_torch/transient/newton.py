"""Implicit-step Newton solver (PyTorch).

Port of ``iemic_tpu/transient/newton.py`` (reference
src/transient/Newton.H:6-155): drives a (Theta)Model to convergence for
one implicit time step, x_{k+1} = x_k - J^{-1} F(x_k), with the
infinity-norm update test and a blow-up guard.  The two norms of an
iteration cross to the host together.
"""

from __future__ import annotations

import torch

from ..utils import logging as log


class Newton:
    def __init__(self, model, params: dict | None = None):
        params = params or {}
        self.model = model
        self.tol = params.get("Newton tolerance", 1e-8)
        self.max_steps = params.get("maximum Newton iterations", 20)
        self.converged = False
        self.steps = 0
        self.norm_dx = 0.0
        self.norm_F = -1.0
        self.Fx = None

    def _F(self, x):
        self.model.set_state(x)
        self.model.compute_rhs()
        return self.model.get_rhs()

    def _Jsol(self, x, b):
        self.model.set_state(x)
        self.model.compute_jacobian()
        return self.model.solve(b)

    @log.timed("Newton: run")
    def run(self, x0):
        x = x0
        self.Fx = self._F(x)
        self.norm_F = -1.0
        self.converged = False

        for self.steps in range(self.max_steps):
            dx = self._Jsol(x, self.Fx)
            x = x - dx
            self.Fx = self._F(x)
            self.norm_dx, self.norm_F = log.host(torch.stack(
                [dx.abs().max(), torch.linalg.norm(self.Fx)])).tolist()

            log.INFO(f"  Newton iter {self.steps}: ||F||={self.norm_F:.3e}"
                     f" ||dx||inf={self.norm_dx:.3e}")

            if self.norm_dx < self.tol and self.norm_F < self.tol:
                self.converged = True
                self.steps += 1
                return x
            if self.norm_dx > 1e2:
                log.WARNING(f"Norm exploding! ||dx||inf={self.norm_dx:.3e}")
                break
        self.steps += 1
        log.WARNING(f"Newton did not converge in {self.steps} steps, "
                    f"||F||={self.norm_F:.3e}")
        return x
