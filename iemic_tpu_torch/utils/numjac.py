"""NumericalJacobian — dense finite-difference Jacobian for serial
verification (PyTorch).

Port of ``iemic_tpu/utils/numjac.py`` (the reference's
NumericalJacobian.H:7-60 and the ``testEntries`` comparator,
src/tests/TestDefinitions.H:72-100): the full Jacobian by central
differences of a residual function, compared against an analytic
Jacobian application.  Only for tiny test grids.

The columns are evaluated one call pair at a time, like the reference's,
not as the JAX package's ``vmap`` batch: the port's ocean residual
writes its state into zero-initialised ghost arrays in place
(``nonlin.usol``), which ``torch.func.vmap`` cannot batch.
"""

from __future__ import annotations

import numpy as np
import torch


class NumericalJacobian:
    """Dense FD Jacobian with CCS accessors (reference
    NumericalJacobian.H's beg/jco/co arrays)."""

    def __init__(self, fn, x: torch.Tensor, *, eps: float = 1e-6):
        """fn: residual function mapping a flat (N,) tensor to (N,).
        x: linearization point (flat); the columns are computed on its
        device and kept as a numpy matrix."""
        N = x.shape[0]
        cols = torch.empty((N, N), dtype=x.dtype, device=x.device)
        for j in range(N):
            v = torch.zeros_like(x)
            v[j] = eps
            cols[j] = (fn(x + v) - fn(x - v)) / (2.0 * eps)
        self.mat = cols.T.cpu().numpy()                     # (N, N)
        self.shape = self.mat.shape
        self.device = x.device

    # -- CCS view (reference's compressed-column arrays) --------------
    def ccs(self, drop_tol: float = 0.0):
        """Return (beg, jco, co): column pointers, row indices, values."""
        N = self.shape[1]
        beg, jco, co = [0], [], []
        for j in range(N):
            nz = np.nonzero(np.abs(self.mat[:, j]) > drop_tol)[0]
            jco.extend(nz.tolist())
            co.extend(self.mat[nz, j].tolist())
            beg.append(len(jco))
        return np.asarray(beg), np.asarray(jco), np.asarray(co)

    def test_entries(self, apply_matrix, *, tol: float = 1e-4,
                     norm_scale: bool = True) -> float:
        """Compare analytic J e_j (apply_matrix of a flat tensor) against
        the FD columns (the testEntries pattern).  Returns the largest
        column error over the largest entry; raises AssertionError above
        tol."""
        N = self.shape[1]
        scale = max(np.abs(self.mat).max(), 1e-300) if norm_scale else 1.0
        worst = 0.0
        for j in range(N):
            ej = torch.zeros(N, dtype=torch.float64, device=self.device)
            ej[j] = 1.0
            aj = apply_matrix(ej).detach().cpu().numpy().ravel()
            worst = max(worst,
                        float(np.abs(aj - self.mat[:, j]).max() / scale))
        if not worst < tol:
            raise AssertionError(f"Jacobian entry mismatch: {worst} >= {tol}")
        return worst
