"""IDR(s) Krylov solver, an alternative to (F)GMRES (PyTorch).

Port of ``iemic_tpu/solvers/idr.py`` (the reference's templated IDR(s)
solver with residual smoothing, src/idrsolver/IDRSolverDecl.H:19-70):
IDR(s) with bi-orthogonalization (van Gijzen & Sonneveld, ACM TOMS 2011),
right-preconditioned, optional minimal-residual smoothing.  Host-driven:
the N-vectors are f64 tensors on b's device, where ``matvec`` and ``prec``
run, and the s x s bookkeeping stays on the host in numpy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class IDRResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: float
    converged: bool


def idr_host(matvec: Callable, b: torch.Tensor, *, s: int = 4,
             prec: Callable | None = None, tol: float = 1e-8,
             maxiter: int = 200, smoothing: bool = True,
             kappa: float = 0.7, seed: int = 0) -> IDRResult:
    """Solve A x = b with IDR(s).  ``matvec``/``prec`` map flat tensors on
    b's device to flat tensors; the shadow space comes from
    ``np.random.default_rng(seed)``."""
    if prec is None:
        prec = lambda v: v  # noqa: E731
    b = b.reshape(-1).to(torch.float64)
    kw = dict(dtype=torch.float64, device=b.device)
    n = b.shape[0]
    s = min(s, n)

    def amul(v):
        return matvec(v).reshape(-1).to(torch.float64)

    def pmul(v):
        return prec(v).reshape(-1).to(torch.float64)

    def host(t):
        return t.cpu().numpy()

    bnorm = float(torch.linalg.norm(b))
    target = tol * (bnorm if bnorm > 0 else 1.0)

    x = torch.zeros(n, **kw)
    r = b.clone()
    rnorm = bnorm
    if rnorm <= target:
        return IDRResult(x, 0, 0.0, True)

    rng = np.random.default_rng(seed)
    P = torch.as_tensor(np.linalg.qr(rng.standard_normal((n, s)))[0], **kw)

    G = torch.zeros((n, s), **kw)
    U = torch.zeros((n, s), **kw)
    M = np.eye(s)
    om = 1.0
    nmv = 0

    # minimal-residual smoothing state (reference: 'Smoothing' option)
    xs, rs = x.clone(), r.clone()

    def smooth(xs, rs, x, r):
        d = rs - r
        dd = float(d @ d)
        gamma = float(rs @ d) / dd if dd > 0 else 0.0
        return xs + gamma * (x - xs), rs - gamma * d

    while nmv < maxiter and rnorm > target:
        f = host(P.T @ r)
        for k in range(s):
            c = torch.as_tensor(np.linalg.solve(M[k:, k:], f[k:]), **kw)
            v = pmul(r - G[:, k:] @ c)
            U[:, k] = U[:, k:] @ c + om * v
            G[:, k] = amul(U[:, k])
            nmv += 1
            for i in range(k):
                alpha = float(P[:, i] @ G[:, k]) / M[i, i]
                G[:, k] -= alpha * G[:, i]
                U[:, k] -= alpha * U[:, i]
            M[k:, k] = host(P[:, k:].T @ G[:, k])
            if M[k, k] == 0.0:
                return IDRResult(xs if smoothing else x, nmv,
                                 rnorm / max(bnorm, 1e-300), False)
            beta = f[k] / M[k, k]
            r = r - beta * G[:, k]
            x = x + beta * U[:, k]
            rnorm = float(torch.linalg.norm(r))
            if smoothing:
                xs, rs = smooth(xs, rs, x, r)
            if rnorm <= target or nmv >= maxiter:
                break
            if k + 1 < s:
                f[k + 1:] = f[k + 1:] - beta * M[k + 1:, k]
        if rnorm <= target or nmv >= maxiter:
            break
        # dimension-reduction step: enter the next Sonneveld space
        v = pmul(r)
        t = amul(v)
        nmv += 1
        tt = float(t @ t)
        if tt == 0.0:
            break
        tr = float(t @ r)
        om = tr / tt
        # kappa angle maintenance (van Gijzen & Sonneveld eq. 4.2)
        rho = abs(tr) / (np.sqrt(tt) * max(rnorm, 1e-300))
        if rho < kappa:
            om *= kappa / rho
        x = x + om * v
        r = r - om * t
        rnorm = float(torch.linalg.norm(r))
        if smoothing:
            xs, rs = smooth(xs, rs, x, r)

    if smoothing:
        x, rnorm = xs, float(torch.linalg.norm(rs))
    return IDRResult(x, nmv, float(rnorm / max(bnorm, 1e-300)),
                     bool(rnorm <= target))
