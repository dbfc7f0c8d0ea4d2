"""Adaptive implicit time stepping (PyTorch).

Port of ``iemic_tpu/transient/adaptive.py`` (reference
src/transient/AdaptiveTransient.H:9-216): theta steps with Newton,
adapting dt on Newton iteration counts, with tdata output.  A model that
has ``save_state_to_file`` (the port's ``ThetaModel`` forwards its inner
model's) writes ``transient_<t>.h5`` at the "HDF5 output frequency".
"""

from __future__ import annotations

import torch

from ..utils import logging as log
from .newton import Newton
from .transient import Transient


class AdaptiveTransient(Transient):
    def __init__(self, model, params: dict | None = None, x0=None):
        super().__init__()
        params = params or {}
        self.model = model
        self.newton = Newton(model, params)
        self.adaptive = params.get("adaptive time steps", False)
        self.min_wanted = params.get("minimum desired Newton iterations", 3)
        self.max_wanted = params.get("maximum desired Newton iterations", 3)
        self.min_dt = params.get("minimum time step", 1.0e-8)
        self.max_dt = params.get("maximum time step", 1.0)
        self.dt_increase = params.get("time step increase", 2.0)
        self.dt_decrease = params.get("time step decrease", 2.0)
        self.nsteps = params.get("number of time steps", 10)
        self.output = params.get("HDF5 output frequency", 1)
        self.total_newton_steps = 0
        self._init_wd = True
        self.set_parameters(params)
        self.x0 = x0
        self.time = 0.0

    def run(self) -> int:
        """(AdaptiveTransient.H:87-171)"""
        x = self.model.get_state() if self.x0 is None else self.x0
        self.time_steps = 0
        self.time = 0.0

        def test_step():
            return True if self.nsteps < 0 else \
                self.time_steps < self.nsteps

        while self.time < self.tmax and test_step():
            log.INFO(f"Timestepping: t = "
                     f"{self.time * self.in_years:.6e} y, dt = {self.dt}")
            # advance the seasonal forcing cycle (THCM::setParameter
            # 'Time', THCM.C:1883-1903; no-op for constant forcing)
            if hasattr(self.model, "set_par"):
                self.model.set_par("Time", self.time + self.dt)
            self.model.set_state(x)
            self.model.init_step(self.dt)
            y = self.newton.run(x)

            if not self.newton.converged:
                log.WARNING(f"Newton did not converge! "
                            f"||F|| = {self.newton.norm_F:.3e}; restoring")
                if self.dt == self.min_dt or not self.adaptive:
                    log.WARNING("minimum timestep reached, exiting...")
                    return 1
                self.dt = max(self.dt / self.dt_decrease, self.min_dt)
                continue

            self.time_steps += 1
            self.time += self.dt
            x = y
            self.model.post_process()

            if self.output > 0 and self.time_steps % self.output == 0 \
                    and hasattr(self.model, "save_state_to_file"):
                self.model.save_state_to_file(
                    f"transient_{self.time:.8g}.h5")

            self.write_data()

            if self.adaptive and self.newton.steps < self.min_wanted:
                self.dt = min(self.dt * self.dt_increase, self.max_dt)
            elif self.adaptive and self.newton.steps > self.max_wanted:
                self.dt = max(self.dt / self.dt_decrease, self.min_dt)

            self.total_newton_steps += self.newton.steps
        return 0

    def write_data(self):
        """tdata output (AdaptiveTransient.H:174-214)."""
        if self._init_wd:
            log.write_cdata(f"#{'time_(y)':>15}{'step':>8}{'dt_(y)':>16}"
                            f"{'|x|':>16}{'NR':>8}"
                            + self.model.write_data(True))
            self._init_wd = False
        nrm = float(torch.linalg.vector_norm(self.model.get_state()))
        log.write_cdata(
            f"{self.time * self.in_years:>16.8e}{self.time_steps:>8d}"
            f"{self.dt * self.in_years:>16.8e}{nrm:>16.8e}"
            f"{self.newton.steps:>8d}" + self.model.write_data(False))
