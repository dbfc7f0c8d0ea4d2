"""Theta-method time stepping as a Model transform (PyTorch).

Port of ``iemic_tpu/transient/theta.py`` (the reference's ThetaModel /
StochasticThetaModel decorators, src/transient/ThetaModel.H:9-165,
StochasticThetaModel.H:11-84): wrap a Model's RHS and Jacobian into the
implicit theta-stepping residual

    M u_n + dt*theta*F(u_{n+1}) + dt*(1-theta)*F(u_n) - M u_{n+1} = 0

with Jacobian J - M/(theta dt) and the scaled solve J2 x = b/(theta dt).
The wrapper holds the inner model and forwards the Model contract; all
vectors are the inner model's tensors, on its device.

Unlike the JAX package's wrapper, this one also forwards
``save_state_to_file`` where the inner model has it, so that
``AdaptiveTransient`` writes the transient states its "HDF5 output
frequency" asks for (ROADMAP queue 3: the JAX wrapper has no such method,
and the JAX ``time_ocean`` writes none).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import logging as log


class ThetaModel:
    def __init__(self, model, params: dict | None = None):
        params = params or {}
        self.model = model
        self.theta = params.get("theta", 1.0)
        self.timestep = 1.0e-3
        self.old_state = model.get_state()
        self.old_rhs = None
        self.rhs = None
        self.sol = None
        if hasattr(model, "save_state_to_file"):
            self.save_state_to_file = model.save_state_to_file

    # -- stepping ------------------------------------------------------
    def init_step(self, timestep: float) -> None:
        """Freeze u_n and F(u_n) for the coming implicit solve
        (ThetaModel.H:64-74)."""
        self.timestep = timestep
        self.old_state = self.model.get_state()
        self.model.pre_process()
        self.model.compute_rhs()
        self.old_rhs = self.model.get_rhs()

    # -- Model contract ------------------------------------------------
    def set_state(self, x) -> None:
        self.model.set_state(x)

    def get_state(self, mode: str = 'C'):
        return self.model.get_state(mode)

    def get_rhs(self, mode: str = 'C'):
        return self.rhs

    def get_solution(self, mode: str = 'C'):
        return self.sol

    def set_par(self, name, value):
        # a toy model need not implement the parameter interface; the
        # 'Time' broadcast for seasonal forcing is then a no-op
        if hasattr(self.model, "set_par"):
            self.model.set_par(name, value)

    def get_par(self, name):
        return self.model.get_par(name)

    def compute_rhs(self) -> None:
        """Theta residual (ThetaModel.H:87-113)."""
        if not (0.0 <= self.theta <= 1.0):
            log.WARNING(f"ThetaModel: incorrect theta {self.theta}")
        self.model.compute_rhs()
        self.model.compute_mass_matrix()
        xdot = self.old_state - self.model.get_state()
        Bxdot = self.model.apply_mass_matrix(xdot)
        self.rhs = (self.timestep * self.theta * self.model.get_rhs()
                    + self.timestep * (1.0 - self.theta) * self.old_rhs
                    + Bxdot)

    def compute_jacobian(self) -> None:
        """J2 = J - M/(theta dt) via the model's mass-diagonal hook
        (ThetaModel.H:118-146)."""
        self.model.compute_jacobian()
        if self.theta == 0.0:
            return
        self.model.compute_mass_matrix()
        self.model.add_mass_to_jacobian(-1.0 / self.timestep / self.theta)

    def compute_mass_matrix(self) -> None:
        self.model.compute_mass_matrix()

    def apply_matrix(self, v):
        return self.model.apply_matrix(v)

    def apply_mass_matrix(self, v):
        return self.model.apply_mass_matrix(v)

    def solve(self, b):
        """J2 x = b/(theta dt) (ThetaModel.H:150-164)."""
        if self.theta == 0.0:
            self.model.compute_mass_matrix()
            M = self.model.diagB
            self.sol = -b / torch.where(M != 0.0, M, 1.0)
            return self.sol
        self.sol = self.model.solve(b / self.timestep / self.theta)
        return self.sol

    def pre_process(self):
        self.model.pre_process()

    def post_process(self):
        self.model.post_process()

    def monitor(self):
        return self.model.monitor()

    def write_data(self, describe: bool = False):
        return self.model.write_data(describe)

    @property
    def solve_iters(self):
        return getattr(self.model, "solve_iters", 0)


class StochasticThetaModel(ThetaModel):
    """Adds G dW noise to the theta residual
    (StochasticThetaModel.H:11-84).  The inner model must provide
    ``compute_stochastic_forcing() -> apply(pert) -> field`` mapping a
    noise tensor to a state-shaped forcing (the Fortran
    ``stochastic_forcing`` matrix B, forcing.F90:220-265).

    The noise is drawn on the host from ``np.random.default_rng(seed)``,
    the JAX package's stream, so both packages draw the same noise for the
    same seed; only its n_noise values go to the device."""

    def __init__(self, model, params: dict | None = None):
        super().__init__(model, params)
        params = params or {}
        self.sigma = params.get("sigma", 1.0)
        self.rng = np.random.default_rng(params.get("seed", 0))
        self.apply_noise = model.compute_stochastic_forcing()
        self.G = None

    def init_step(self, timestep: float) -> None:
        super().init_step(timestep)
        x = self.model.get_state()
        pert = torch.as_tensor(
            self.rng.standard_normal(self.apply_noise.n_noise),
            dtype=x.dtype, device=x.device)
        self.G = (self.apply_noise(pert)
                  * np.sqrt(self.timestep) * self.sigma)

    def compute_rhs(self) -> None:
        super().compute_rhs()
        self.rhs = self.rhs + self.G
