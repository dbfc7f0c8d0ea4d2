"""RAILS: Residual Approximation-based Iterative Lyapunov Solver
(PyTorch).

Port of ``iemic_tpu/lyapunov/rails.py``.  Low-rank solver for the
(projected) continuous Lyapunov equation

    A X + X A^T + B B^T = 0

in place of the reference's external RAILS C++ library (reference
.travis.yml:89-106, the solver invoked by
src/lyapunov/LyapunovModel.H:60-90).  The algorithm (Baars, Viebahn,
Mulder, Kuehn, Wubs, Dijkstra — "Application of adaptive multilevel
methods...") iterates:

  1. keep an orthonormal search space V (n, k), k small;
  2. solve the k x k projected equation (V^T A V) T + T (V^T A V)^T
     = -(V^T B)(V^T B)^T  directly on the host (tiny dense solve);
  3. form the residual R = A V T V^T + V T V^T A^T + B B^T implicitly
     and expand V with its dominant eigenvectors, obtained by a few
     Lanczos iterations on the *matrix-free* residual matvec;
  4. restart (truncate V via the dominant eigenspace of T) when k
     exceeds a cap.

The search space, the operator products, the Lanczos vectors and the
orthogonalisation are f64 tensors on the device of B; the k x k
Lyapunov solve, the tridiagonal eigenproblem and the eigenvectors of T
run on the host (scipy, numpy).  Random vectors come from a numpy
generator, the JAX package's stream, so both packages take the same
steps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg as sla
import torch

F64 = torch.float64


class RailsResult(NamedTuple):
    V: torch.Tensor      # (n, k) orthonormal basis, on B's device
    T: np.ndarray        # (k, k) small solution;  X = V T V^T
    resnorm: float       # final residual estimate (dominant |eig| of R)
    iterations: int
    converged: bool


def _orth_against(W, V, reorth: int = 2, rtol: float = 1e-10):
    """Orthonormalize columns of W against V (and internally).

    SVD-based: QR of a rank-deficient block yields arbitrary trailing
    Q columns (not orthogonal to V); the SVD drops the null directions
    instead of inventing them."""
    for _ in range(reorth):
        if V is not None and V.shape[1] > 0:
            W = W - V @ (V.T @ W)
        if W.numel() == 0:
            return W
        U, s, _ = torch.linalg.svd(W, full_matrices=False)
        smax = float(s.max()) if s.numel() else 0.0
        W = U[:, s > rtol * max(smax, 1e-300)]
    return W


def _residual_lanczos(AV, V, T, B, k_expand: int, lanczos_iters: int,
                      rng: np.random.Generator):
    """Dominant eigenpairs of the symmetric residual
    R = (AV) T V^T + V T (AV)^T + B B^T via Lanczos on its matvec."""
    n = V.shape[0]
    Td = torch.as_tensor(T, dtype=F64, device=V.device)
    TVt = Td @ V.T
    TAVt = Td @ AV.T

    def rmul(w):
        return AV @ (TVt @ w) + V @ (TAVt @ w) + B @ (B.T @ w)

    m = min(lanczos_iters, n - 1)
    Q = torch.zeros((n, m + 1), dtype=F64, device=V.device)
    alpha = np.zeros(m)
    beta = np.zeros(m + 1)
    q = torch.as_tensor(rng.standard_normal(n), dtype=F64, device=V.device)
    Q[:, 0] = q / torch.linalg.vector_norm(q)
    for j in range(m):
        w = rmul(Q[:, j])
        if j > 0:
            w = w - beta[j] * Q[:, j - 1]
        alpha[j] = float(Q[:, j] @ w)
        w = w - alpha[j] * Q[:, j]
        # full reorthogonalization: m is tiny
        w = w - Q[:, :j + 1] @ (Q[:, :j + 1].T @ w)
        beta[j + 1] = float(torch.linalg.vector_norm(w))
        if beta[j + 1] < 1e-14:
            m = j + 1
            break
        Q[:, j + 1] = w / beta[j + 1]
    Tm = np.diag(alpha[:m]) + np.diag(beta[1:m], 1) + np.diag(beta[1:m], -1)
    evals, evecs = np.linalg.eigh(Tm)
    order = np.argsort(-np.abs(evals))
    resnorm = float(np.abs(evals[order[0]])) if m > 0 else 0.0
    sel = order[:k_expand]
    W = Q[:, :m] @ torch.as_tensor(evecs[:, sel], dtype=F64, device=V.device)
    return W, resnorm


def rails(amul: Callable, B, *,
          tol: float = 1e-6,
          maxiter: int = 100,
          expand: int = 3,
          restart_size: int = 60,
          reduced_size: int = 30,
          lanczos_iters: int = 20,
          seed: int = 42) -> RailsResult:
    """Solve A X + X A^T + B B^T = 0 for low-rank X = V T V^T.

    Parameters
    ----------
    amul : callable mapping an (n, k) f64 tensor on B's device to
        A @ block there.
    B : (n, nb) noise/input factor, a tensor (its device is the solve's)
        or a numpy array (the solve runs on the CPU).
    tol : convergence on the dominant residual eigenvalue relative to
        the dominant eigenvalue of B B^T.
    """
    B = torch.as_tensor(B, dtype=F64)
    if B.ndim == 1:
        B = B[:, None]
    n = B.shape[0]
    dev = B.device
    rng = np.random.default_rng(seed)

    def randn(k):
        return torch.as_tensor(rng.standard_normal((n, k)), dtype=F64,
                               device=dev)

    def avmul(W):
        return amul(W).to(F64)

    # reference scale: ||BB^T|| ~ dominant singular value of B squared
    bscale = float(torch.linalg.matrix_norm(B, 2)) ** 2
    bscale = bscale if bscale > 0 else 1.0

    V = _orth_against(B.clone(), None)
    if V.shape[1] == 0:
        V = _orth_against(randn(1), None)
    T = np.zeros((V.shape[1], V.shape[1]))
    resnorm = np.inf
    converged = False
    it = 0
    Vused = V
    for it in range(1, maxiter + 1):
        AV = avmul(V)
        Ak = (V.T @ AV).cpu().numpy()      # (k, k) projected operator
        Bk = (V.T @ B).cpu().numpy()
        T = sla.solve_lyapunov(Ak, -(Bk @ Bk.T))
        Vused = V                          # basis consistent with T
        W, resnorm = _residual_lanczos(AV, V, T, B, expand,
                                       lanczos_iters, rng)
        if resnorm <= tol * bscale:
            converged = True
            break
        # restart: truncate to dominant eigenspace of T
        if V.shape[1] + W.shape[1] > restart_size:
            evals, evecs = np.linalg.eigh(T)
            order = np.argsort(-np.abs(evals))[:reduced_size]
            V = V @ torch.as_tensor(evecs[:, order], dtype=F64, device=dev)
            V = _orth_against(V, None)
        W = _orth_against(W, V)
        if W.shape[1] == 0:
            W = _orth_against(randn(1), V)
            if W.shape[1] == 0:
                break
        V = torch.cat([V, W], dim=1)
    return RailsResult(V=Vused, T=T, resnorm=resnorm, iterations=it,
                       converged=converged)
