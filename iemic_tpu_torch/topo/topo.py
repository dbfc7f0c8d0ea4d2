"""Homotopy continuation between land masks (topography), PyTorch.

Port of ``iemic_tpu/topo/topo.py``, the analog of the reference's
Topo<Model, ParameterList> (reference src/topo/TopoDecl.H:46+,
src/topo/Topo.H:328-470 and the derivation in
notes/topography/homotopy.org:24-41): deform the steady state of the
ocean under land mask A into the steady state under land mask B by
continuation in the homotopy parameter "Delta":

    F_h(x, delta) = facA * M (x - x_A)  +  S_delta * F_B(x)

with facA = cos^2(pi delta / 2), facB = sin^2(pi delta / 2),
M the mass-matrix diagonal (Ro for u,v; 0 for w,p; 1 for T,S; 0 on
land) and the row scaling S_delta = facB on rows with M != 0 and 1 on
w/p/land/integral rows — exactly the reference's scaled formulation
(Topo.H:328-372): prognostic rows blend a relaxation to the stored
mask-A state x_A with the mask-B physics, while continuity, dummy and
integral rows always hold exactly.

The Jacobian stays a 27-point stencil tensor:
    J_h = S_delta * J_B  +  facA * diag(M)
(Topo.H:416-460: row scale + diagonal replacement), so the ocean's
whole solve stack — THCM row scaling, the configured precision (with
Mixed, the f32 inner Krylov operator is the Hopper stencil kernel on the
row-scaled blended tensor), the GMRES-IR tail and the pressure deflator
— runs on the blended tensor.  The JAX package's ``Topo.solve`` runs its
f64 solve on the unscaled blended tensor whatever ``Precision`` says
(ROADMAP queue 3); this one does what its docstring promises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ParameterList
from ..utils import logging as log


def default_topo_params(n_masks: int = 0) -> ParameterList:
    """Defaults of the reference's topo_params.xml
    (reference test/topo/topo_params.xml), with a "Mask file <i>" entry
    for each of n_masks mask files.  The JAX package's defaults have no
    such entry, so its Topo refuses every list that names a mask file
    (ROADMAP queue 3)."""
    p = ParameterList("Topo parameters")
    p.set("Number of mask files", n_masks)
    for i in range(n_masks):
        p.set(f"Mask file {i}", "")
    p.set("Starting mask", 0)
    p.set("Save frequency", 0)
    p.set("Stopping tolerance homotopy", -1.0)
    p.set("Use predictor type (I)", False)
    p.set("Disable postprocessing", False)
    return p


class Topo:
    """Model-contract wrapper running the mask homotopy on an Ocean."""

    def __init__(self, model, pars: ParameterList | dict | None = None):
        if pars is None:
            pars = ParameterList("Topo parameters")
        if isinstance(pars, dict):
            pars = ParameterList("Topo parameters", pars)
        pars.validate_and_set_defaults(default_topo_params(
            pars["Number of mask files"] if "Number of mask files" in pars
            else 0))
        self.pars = pars
        self.model = model

        self.n_masks = pars.get("Number of mask files")
        self.start_mask = pars.get("Starting mask")
        self.stop_tol = pars.get("Stopping tolerance homotopy")
        self.masks: list[np.ndarray] = []
        for i in range(self.n_masks):
            fname = pars.get(f"Mask file {i}")
            self.masks.append(model.get_land_mask(fname))
        self.k = self.start_mask     # current leg: A = k, B = k+1
        self.delta = 0.0
        self.norm_fB = np.inf

        self.state_A = None          # x_A, converged state under mask A
        self.vecM = None             # mass diagonal under mask B
        self.rhs = None
        self.sol = None
        self.jac = None              # blended stencil tensor

    # -- homotopy setup -------------------------------------------------
    def set_mask_index(self, k: int) -> None:
        self.k = k

    def set_masks(self, masks: list[np.ndarray]) -> None:
        """Directly install raw (l, m, n) masks (test convenience)."""
        self.masks = list(masks)
        self.n_masks = len(self.masks)

    def initialize(self) -> None:
        """Start the leg masks[k] -> masks[k+1]: store x_A, switch the
        model to mask B, compute the mass diagonal and row scaling
        (reference Topo.H:112-134)."""
        log.INFO(f"Topo: initialize leg {self.k} -> {self.k + 1}")
        self.delta = 0.0
        self.state_A = self.model.get_state()
        self.model.set_land_mask(self.masks[self.k + 1], file_ghosts=True)
        self.model.compute_mass_matrix()
        self.vecM = self.model.diagB
        self._scale = (self.vecM.abs() < 1e-12).to(self.vecM.dtype)
        self.norm_fB = np.inf

    def predictor(self) -> None:
        """Reference Topo::predictor (Topo.H:139-160).  The optional
        type-(I) secant predictor over previous mask legs is not
        carried over; the plain path just refreshes the RHS."""
        self.compute_rhs()

    def _facs(self) -> tuple[float, float]:
        facA = math.cos(math.pi * self.delta / 2) ** 2
        facB = math.sin(math.pi * self.delta / 2) ** 2
        return facA, facB

    def _row_scale(self, facB: float) -> torch.Tensor:
        # facB on prognostic rows, 1 on w/p/land/integral rows
        return self._scale + (1.0 - self._scale) * facB

    # -- Model contract --------------------------------------------------
    def compute_rhs(self) -> None:
        facA, facB = self._facs()
        self.model.compute_rhs()
        fB = self.model.get_rhs()
        self.norm_fB = float(torch.linalg.vector_norm(fB))
        x = self.model.get_state()
        self.rhs = (self._row_scale(facB) * fB
                    + facA * self.vecM * (x - self.state_A))
        log.INFO(f"Topo: Delta={self.delta:.8e} "
                 f"|F_h|={float(torch.linalg.vector_norm(self.rhs)):.3e} "
                 f"|F_B|={self.norm_fB:.3e}")

    def compute_jacobian(self) -> None:
        facA, facB = self._facs()
        self.model.compute_jacobian()
        An = self.model.jac * self._row_scale(facB)[None, :, None]
        # stencil location 4 = (di,dj,dk)=(0,0,0), the diagonal
        for a in range(An.shape[1]):
            An[4, a, a] += facA * self.vecM[a]
        self.jac = An

    def solve(self, b):
        """Blended-tensor solve through the ocean's solve stack: THCM row
        scaling of the blended tensor, the configured Precision, the
        GMRES-IR tail and the pressure deflator of J_B (whose null modes
        the blended tensor keeps: facA * M vanishes on the p rows).  The
        factors and the prepared f32 operator are built once per blended
        tensor and shared by the solves of one Newton iteration; the
        ocean's jac stays J_B."""
        m = self.model
        if m.jac is None:
            m.compute_jacobian()
        self.sol = m._solve_operator(self.jac, b)
        return self.sol

    def apply_matrix(self, v):
        return self.model._apply(self.jac, v)

    def get_state(self, mode: str = "C"):
        return self.model.get_state(mode)

    def set_state(self, x) -> None:
        self.model.set_state(x)

    def get_rhs(self, mode: str = "C"):
        return self.rhs

    def get_solution(self, mode: str = "C"):
        return self.sol

    def set_par(self, name: str, value: float) -> None:
        if name == "Delta":
            self.delta = float(value)
        else:
            self.model.set_par(name, value)

    def get_par(self, name: str) -> float:
        if name == "Delta":
            return self.delta
        return self.model.get_par(name)

    def pre_process(self) -> None:
        self.model.pre_process()

    def post_process(self) -> None:
        if not self.pars.get("Disable postprocessing"):
            self.model.post_process()

    def monitor(self) -> bool:
        """Early-stop hook: the mask-B steady state may be reached
        before delta hits 1 (reference Topo.H:375-379)."""
        if self.stop_tol <= 0:
            return False
        return self.norm_fB < self.stop_tol or self.delta > 1.0

    def write_data(self, describe: bool = False) -> str:
        if describe:
            return self.model.write_data(True) + f"  {'|fB|':>12}"
        return self.model.write_data(False) + f"  {self.norm_fB:12.4e}"
