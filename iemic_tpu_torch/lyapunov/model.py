"""LyapunovModel — decorator adding covariance solves at post_process
(PyTorch).

Port of ``iemic_tpu/lyapunov/model.py``, the analog of the reference's
``LyapunovModel<Model>`` (reference src/lyapunov/LyapunovModel.H:22-110):
at every converged continuation point, solve the generalized Lyapunov
equation

    A X M^T + M X A^T + B B^T = 0

for the stationary covariance X of the linearized stochastically forced
system, by Schur complement onto the mass dofs (M's diagonal is zero on
w and p rows — reference handles the same singular-mass structure,
including the pressure checkerboard nullspace, via a projected solve).

With diagonal M restricted to its nonzero block (M1):
    S = A11 - A12 A22^+ A21           (Schur complement)
    Z = M1 X11 M1,  Atil = S M1^{-1}  =>  Atil Z + Z Atil^T + B1 B1^T = 0
solved low-rank by :func:`iemic_tpu_torch.lyapunov.rails.rails`.

The dense Jacobian, the Schur complement, Atil and the search space of
rails are f64 tensors on the model's device; A22^+ is the minimal-norm
solve of numpy's ``lstsq`` (LAPACK gelsd), on the card by an SVD with
the same cut (``min_norm_solve``), because on CUDA ``torch.linalg.lstsq``
has only the full-rank ``gels`` driver, and A22 is rank-deficient (the
pressure checkerboard).  The
``results`` records hold host numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from ..utils import logging as log
from .rails import rails

F64 = torch.float64


def min_norm_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The minimal-norm least-squares solution of A Y = B, as
    ``np.linalg.lstsq(A, B, rcond=None)`` (LAPACK gelsd) gives it: on the
    host that call itself, on the card an SVD with gelsd's cut
    (``svd_min_norm``).  PyTorch's own host SVD (gesdd) does not converge
    on run/lyapunov's (w, p) block."""
    if A.is_cuda:
        return svd_min_norm(A, B)
    return torch.as_tensor(np.linalg.lstsq(A.numpy(), B.numpy(),
                                           rcond=None)[0])


def svd_min_norm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The minimal-norm solution of A Y = B from the SVD of A, singular
    values at or below eps * max(A.shape) * s_max counting as zero (the
    cut of numpy's lstsq with rcond=None), on A's device."""
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    if s.numel() == 0:
        return torch.zeros((A.shape[1],) + B.shape[1:], dtype=B.dtype,
                           device=B.device)
    keep = s > torch.finfo(A.dtype).eps * max(A.shape) * s[0]
    return Vh[keep].T @ ((U[:, keep].T @ B) / s[keep, None])


@contextmanager
def _timed(what: str, seconds: dict, device: torch.device):
    """Time the block into seconds[what] and the profile's
    "Lyapunov: <what>" timer, waiting for the device at its end so that
    the host clock reads the work and not its enqueue."""
    t0 = time.perf_counter()
    with log.timer("Lyapunov: " + what):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    seconds[what] = time.perf_counter() - t0


class LyapunovModel:
    """Wrap any Model; delegates everything, adds covariance solves."""

    def __init__(self, model, params: dict | None = None):
        self._model = model
        p = dict(params or {})
        self.tol = float(p.get("Tolerance", 1e-5))
        self.maxiter = int(p.get("Maximum Iterations", 100))
        self.expand = int(p.get("Expand Size", 3))
        self.restart_size = int(p.get("Restart Size", 60))
        self.reduced_size = int(p.get("Reduced Size", 30))
        self.inner_tol = float(p.get("Schur Solver Tolerance", 1e-8))
        self.noise_amp = float(p.get("Noise Amplitude", 1.0))
        self.enabled = bool(p.get("Enabled", True))
        self.results: list[dict] = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    # -- covariance machinery ------------------------------------------

    def _mass_partition(self):
        """The flat mass diagonal and the boolean masks of the mass and
        the dummy (w, p, land, integral row) dofs, on the model's
        device."""
        m = self._model
        n = m.to_flat().numel()
        ones = torch.ones(n, dtype=F64, device=m.device)
        mdiag = m.to_flat(m.apply_mass_matrix(m.from_flat(ones)))
        mass = mdiag.abs() > 1e-14
        return mdiag, mass, ~mass

    def _noise_factor(self, mass: torch.Tensor) -> torch.Tensor:
        """B restricted to mass dofs.  Models may expose a stochastic
        forcing factor (reference THCM::computeForcing,
        src/ocean/forcing.F90:220-268); default: identity-scaled noise
        on the T,S-like mass dofs, from the JAX package's generator
        (numpy's default_rng(7)), so that both packages solve the same
        equation."""
        m = self._model
        if hasattr(m, "stochastic_forcing_factor"):
            B = torch.as_tensor(m.stochastic_forcing_factor(), dtype=F64,
                                device=m.device)
        else:
            n = mass.numel()
            rng = np.random.default_rng(7)
            B = torch.as_tensor(rng.standard_normal((n, 1)), dtype=F64,
                                device=m.device)
            B[~mass] = 0.0
        if B.ndim == 1:
            B = B[:, None]
        return self.noise_amp * B[mass]

    def _dense_jacobian(self, n: int) -> torch.Tensor:
        """Materialize A by vmapped batches of f64 stencil matvecs on
        identity columns, on the model's device; a batch's stencil
        product (27 x 36 coefficients a cell) is held to 1 GiB.

        Lyapunov solves are only tractable at 2DMOC-scale problems
        (the reference likewise restricts run_lyapunov/intt_2dmoc to
        small grids); batched applies on identity are far cheaper than
        the O(k * inner-Krylov) matrix-free Schur alternative."""
        m = self._model

        def mv(v):
            return m.to_flat(m.apply_matrix(m.from_flat(v)))

        bmv = torch.func.vmap(mv)
        chunk = max(1, (1 << 30) // (27 * 36 * (n // 6) * 8))
        A = torch.empty((n, n), dtype=F64, device=m.device)
        for j0 in range(0, n, chunk):
            j1 = min(n, j0 + chunk)
            eye = torch.zeros((j1 - j0, n), dtype=F64, device=m.device)
            eye[:, j0:j1] = torch.eye(j1 - j0, dtype=F64, device=m.device)
            A[:, j0:j1] = bmv(eye).T              # columns j = A e_j
        return A

    def solve_covariance(self):
        """Solve the projected Lyapunov equation at the current state."""
        m = self._model
        m.compute_jacobian()
        mdiag, mass, dummy = self._mass_partition()
        n = mdiag.numel()
        seconds = {}

        with _timed("dense Jacobian", seconds, m.device):
            A = self._dense_jacobian(n)
        with _timed("Schur complement", seconds, m.device):
            im, idum = mass.nonzero()[:, 0], dummy.nonzero()[:, 0]
            A11 = A[im[:, None], im]
            A12 = A[im[:, None], idum]
            A21 = A[idum[:, None], im]
            A22 = A[idum[:, None], idum]
            del A
            # Schur complement onto the mass dofs; A22 is the (w,p)
            # block.  The minimal-norm solve handles the pressure
            # checkerboard nullspace by projecting it out, as the
            # reference's projected solve does (LyapunovModel.H:
            # checkerboard handling).
            Y = min_norm_solve(A22, A21)
            S = A11 - A12 @ Y
            m1 = mdiag[im]
            Atil = S / m1[None, :]

        B1 = self._noise_factor(mass)
        with _timed("rails", seconds, m.device):
            res = rails(lambda Wm: Atil @ Wm, B1, tol=self.tol,
                        maxiter=self.maxiter, expand=self.expand,
                        restart_size=self.restart_size,
                        reduced_size=self.reduced_size)
            # back-transform: X11 = M1^{-1} Z M1^{-1} = (V/m1) T (V/m1)^T
            Vx = res.V / m1[:, None]
            T = torch.as_tensor(res.T, dtype=F64, device=Vx.device)
            trace = float(torch.sum(Vx * (Vx @ T)))
        evals = np.linalg.eigvalsh(res.T)[::-1]
        out = {
            "par": float(m.get_par("Combined Forcing"))
            if hasattr(m, "get_par") else np.nan,
            "trace": trace,
            "spectrum": evals,
            "resnorm": res.resnorm,
            "iterations": res.iterations,
            "converged": res.converged,
            "V": Vx.cpu().numpy(), "T": res.T, "mass": mass.cpu().numpy(),
            "seconds": seconds,
        }
        self.results.append(out)
        return out

    # -- Model contract passthrough with hook --------------------------

    def post_process(self):
        self._model.post_process()
        if self.enabled:
            r = self.solve_covariance()
            log.INFO("Lyapunov: trace=%.6e res=%.3e its=%d conv=%s"
                     % (r["trace"], r["resnorm"], r["iterations"],
                        r["converged"]))
