"""Flexible GMRES as host loops over device tensors (PyTorch).

Port of ``iemic_tpu/solvers/fgmres.py`` (the reference's Belos flexible
GMRES, Ocean.C:961-1022).  Where the JAX package ran the iteration inside
``lax.while_loop``, here the loop runs on the host: the Krylov basis and
the matvec / preconditioner stay on the tensors' device, and the small
Hessenberg / Givens bookkeeping is done in numpy, in the working dtype,
from one device-to-host copy per iteration (``utils.logging.host``; the
Arnoldi step of each iteration is the span ``FGMRES: orthogonalize``).

  * :func:`fgmres_flat` — CGS2 Arnoldi, Givens rotations, ``stall_limit``
  * :func:`fgmres` — the same on tensors of any shape
  * :func:`fgmres_host` — modified Gram-Schmidt variant, used by the
    outer f64 GMRES-IR tail of the mixed-precision solve

Both take ``reduce``, for vectors split over the ranks of a domain
(``parallel.halo``): every inner product and norm is then the local one
summed over the ranks by ``reduce`` (a sum of tensors, in place or not),
and every rank runs the same iteration on its block.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import logging as log


class FGMRESResult(NamedTuple):
    x: torch.Tensor       # flat solution
    iters: int            # iterations performed
    relres: float         # final implicit relative residual
    converged: bool


def _backsub(H: np.ndarray, g: np.ndarray, j: int) -> np.ndarray:
    """Solve the leading j x j upper-triangular system (a zero pivot
    divides by 1, as the jitted loop does)."""
    y = np.zeros(j, H.dtype)
    for i in range(j - 1, -1, -1):
        hii = H[i, i]
        y[i] = (g[i] - H[i, i + 1:j] @ y[i + 1:j]) / (hii if hii != 0 else 1)
    return y


def _sum(reduce, t: torch.Tensor) -> torch.Tensor:
    return t if reduce is None else reduce(t)


def _norms(reduce, *vs: torch.Tensor) -> torch.Tensor:
    """The 2-norms of vs, as one tensor: of the whole vectors, whose
    local dot products reduce sums over the ranks."""
    if reduce is None:
        return torch.stack([torch.linalg.norm(v) for v in vs])
    return torch.sqrt(reduce(torch.stack([torch.dot(v, v) for v in vs])))


def fgmres_flat(matvec: Callable, prec: Callable, b: torch.Tensor,
                x0: torch.Tensor, tol: float, maxiter: int,
                stall_limit: int = 0,
                reduce: Callable | None = None) -> FGMRESResult:
    """Right-preconditioned FGMRES on flat vectors, in b's dtype.

    stall_limit > 0 additionally stops when the (monotone) implicit
    residual has improved by less than 0.1% per iteration for that many
    consecutive iterations — needed when the target sits below the
    working-precision noise floor (the mixed-precision inner solves)."""
    N = b.shape[0]
    ndt = np.float32 if b.dtype == torch.float32 else np.float64
    kw = dict(dtype=b.dtype, device=b.device)

    r0 = b - matvec(x0)
    beta, bnorm = (float(v) for v in log.host(_norms(reduce, r0, b)))
    beta, bnorm = ndt(beta), ndt(bnorm)
    target = ndt(tol) * (bnorm if bnorm > 0.0 else ndt(1.0))

    V = torch.zeros((maxiter + 1, N), **kw)
    Z = torch.zeros((maxiter, N), **kw)
    H = np.zeros((maxiter + 1, maxiter), ndt)
    cs = np.zeros(maxiter, ndt)
    sn = np.zeros(maxiter, ndt)
    g = np.zeros(maxiter + 1, ndt)
    V[0] = r0 / beta if beta > 0.0 else r0
    g[0] = beta
    res = beta
    stall = 0
    j = 0
    while j < maxiter and res > target \
            and (stall_limit <= 0 or stall < stall_limit):
        z = prec(V[j])
        w = matvec(z)
        Z[j] = z
        with log.timer("FGMRES: orthogonalize"):
            # CGS2: two classical Gram-Schmidt passes against the basis
            Vj = V[:j + 1]
            h1 = _sum(reduce, Vj @ w)
            w = w - Vj.T @ h1
            h2 = _sum(reduce, Vj @ w)
            w = w - Vj.T @ h2
            hj1 = _norms(reduce, w)[0]
            V[j + 1] = torch.where(hj1 > 0.0, w / hj1, w)
            col = log.host(torch.cat([h1 + h2, hj1[None]])).numpy()
            Hcol = np.zeros(maxiter + 1, ndt)
            Hcol[:j + 2] = col
            # previous Givens rotations, then the new one
            for i in range(j):
                hi = cs[i] * Hcol[i] + sn[i] * Hcol[i + 1]
                Hcol[i + 1] = -sn[i] * Hcol[i] + cs[i] * Hcol[i + 1]
                Hcol[i] = hi
            denom = np.sqrt(Hcol[j] ** 2 + Hcol[j + 1] ** 2)
            c = Hcol[j] / denom if denom > 0.0 else ndt(1.0)
            s = Hcol[j + 1] / denom if denom > 0.0 else ndt(0.0)
            cs[j], sn[j] = c, s
            Hcol[j] = c * Hcol[j] + s * Hcol[j + 1]
            Hcol[j + 1] = 0.0
            H[:, j] = Hcol
            gj1 = -s * g[j]
            g[j + 1] = gj1
            g[j] = c * g[j]
            res_new = abs(gj1)
            stall = stall + 1 if res_new > res * ndt(0.999) else 0
            res = res_new
        j += 1

    y = torch.as_tensor(_backsub(H, g, j), **kw)
    x = x0 + Z[:j].T @ y
    return FGMRESResult(x=x, iters=j,
                        relres=float(res) / max(float(bnorm), 1e-300),
                        converged=bool(res <= target))


def fgmres_host(matvec: Callable, b: torch.Tensor, *,
                prec: Callable | None = None, tol: float = 1e-8,
                maxiter: int = 100, reduce: Callable | None = None
                ) -> tuple[torch.Tensor, FGMRESResult]:
    """FGMRES with modified Gram-Schmidt for operators that are host
    orchestrations themselves (the GMRES-IR outer loop); f64 on b's
    device.  Returns (x, FGMRESResult)."""
    b = b.reshape(-1)
    N = b.shape[0]
    kw = dict(dtype=b.dtype, device=b.device)
    bnorm = float(log.host(_norms(reduce, b)[0]))
    target = tol * (bnorm if bnorm > 0 else 1.0)
    if prec is None:
        prec = lambda v: v  # noqa: E731

    beta = bnorm
    if beta <= target:
        x = torch.zeros(N, **kw)
        return x, FGMRESResult(x=x, iters=0, relres=0.0, converged=True)

    V = torch.zeros((maxiter + 1, N), **kw)
    Z = torch.zeros((maxiter, N), **kw)
    H = np.zeros((maxiter + 1, maxiter))
    cs = np.zeros(maxiter)
    sn = np.zeros(maxiter)
    g = np.zeros(maxiter + 1)
    V[0] = b / beta
    g[0] = beta
    res = beta
    j = 0
    while j < maxiter and res > target:
        z = prec(V[j]).reshape(-1)
        w = matvec(z).reshape(-1)
        Z[j] = z
        with log.timer("FGMRES: orthogonalize"):
            for i in range(j + 1):
                H[i, j] = float(log.host(_sum(reduce, V[i] @ w)))
                w = w - H[i, j] * V[i]
            H[j + 1, j] = float(log.host(_norms(reduce, w)[0]))
            if H[j + 1, j] > 0:
                V[j + 1] = w / H[j + 1, j]
            for i in range(j):
                hi = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = hi
            denom = np.hypot(H[j, j], H[j + 1, j])
            c, s = (1.0, 0.0) if denom == 0 else (H[j, j] / denom,
                                                  H[j + 1, j] / denom)
            cs[j], sn[j] = c, s
            H[j, j] = c * H[j, j] + s * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            res = abs(g[j + 1])
        j += 1

    y = np.linalg.solve(H[:j, :j], g[:j]) if j else np.zeros(0)
    x = Z[:j].T @ torch.as_tensor(y, **kw)
    return x, FGMRESResult(x=x, iters=j, relres=res / max(bnorm, 1e-300),
                           converged=res <= target)


def fgmres(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
           *, prec: Callable | None = None, tol: float = 1e-8,
           maxiter: int = 100) -> tuple[torch.Tensor, FGMRESResult]:
    """Solve A x = b with right-preconditioned FGMRES; matvec and prec act
    on tensors shaped like b.  Returns (x shaped like b, FGMRESResult)."""
    shape = b.shape

    def flat(fn):
        return lambda v: fn(v.reshape(shape)).reshape(-1)

    res = fgmres_flat(flat(matvec), flat(prec) if prec else lambda v: v,
                      b.reshape(-1),
                      torch.zeros_like(b.reshape(-1)) if x0 is None
                      else x0.reshape(-1), tol, maxiter)
    return res.x.reshape(shape), res
