"""Solver / preconditioner factory (PyTorch).

Port of ``iemic_tpu/solvers/factory.py`` (the reference's
TRIOS::SolverFactory, TRIOS_SolverFactory.C:65-250): dispatch on a
"Method" name, returning (build, apply) closures with the contract

    build(An)         -> factors
    apply(factors, r) -> z ~= J^{-1} r

Methods: "None", "Columns" (:mod:`.preconditioner`), "BGS" (:mod:`.bgs`),
"Teko" (:mod:`.rearranger`), and the two host-side ones, "Amesos" (a
sparse LU of the assembled CSR matrix, scipy) and "MILU" (the native
multilevel ILU, :mod:`iemic_tpu_torch.native.milu`).  Where the JAX package
crossed to the host through ``jax.pure_callback``, the host-side methods
copy the residual to the host, solve there in f64, and return the result
on the residual's device in its dtype.

Plus :func:`make_krylov` (the AztecOO construction analog) and
:func:`spectrum_analysis` (the SolverFactory spectrum probe of P^{-1} A,
TRIOS_SolverFactory.H:22-60).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import ParameterList
from ..ops.stencil import stencil_to_csr, to_flat, from_flat
from ..utils import logging as log


def default_prec_params() -> ParameterList:
    """The JAX package's defaults (factory.py:45-108), unchanged."""
    p = ParameterList("Preconditioner")
    p.set("Method", "Columns")
    p.set("Saddlepoint iterations", 60)
    p.set("Saddlepoint scheme", "SI")
    p.set("Auv iterations", 12)
    p.set("ATS iterations", 0)   # 0 = apply ATS Precond once
    p.set("Saddlepoint tolerance", 1e-8)
    p.set("Auv tolerance", 1e-2)
    p.set("ATS tolerance", 1e-2)
    p.set("ATS rho/mu Transform", False)
    p.set("rho/mu lambda", 7.6e-4 / 1.8e-4)
    p.set("Auv Precond", "Columns")
    p.set("ATS Precond", "MG")
    p.set("Saddlepoint Precond", "Jacobi")
    p.set("MG prolongation weight", 0.25)
    p.set("Permutation", 1)
    p.set("Scheme", "Gauss-Seidel")
    p.set("Teko sweeps", 1)
    p.set("MILU drop tolerance", 1e-3)
    p.set("MILU max levels", 12)
    p.set("MILU fill factor", 10.0)
    for blk in ("Saddlepoint", "Auv", "ATS"):
        s = p.sublist(blk + " Solver")
        s.set("Iterations", -1)          # -1 = keep flat-knob value
        s.set("Tolerance", -1.0)
        s.set("Scheme", "")
        s.set("Precond Method", "")
        s.set("MG prolongation weight", -1.0)
    return p


def _apply_nested_block_lists(params: ParameterList) -> None:
    """Fold the nested per-block sublists into the flat knobs
    (ocean_preconditioner_params.xml:427-560)."""
    for blk, it_key, tol_key, prec_key in [
            ("Saddlepoint", "Saddlepoint iterations",
             "Saddlepoint tolerance", "Saddlepoint Precond"),
            ("Auv", "Auv iterations", "Auv tolerance", "Auv Precond"),
            ("ATS", "ATS iterations", "ATS tolerance", "ATS Precond")]:
        if params.is_sublist(blk + " Solver"):
            sl = params.sublist(blk + " Solver")
            if sl.get("Iterations", -1) >= 0:
                params.set(it_key, int(sl.get("Iterations")))
            if sl.get("Tolerance", -1.0) > 0:
                params.set(tol_key, float(sl.get("Tolerance")))
            if blk == "Saddlepoint" and sl.get("Scheme", ""):
                params.set("Saddlepoint scheme", sl.get("Scheme"))
            if sl.get("Precond Method", ""):
                params.set(prec_key, sl.get("Precond Method"))


def _prolongation_weight(params: ParameterList, blk: str) -> float:
    """The MG prolongation weight of one block: its own sublist's where
    that sets one, else the flat knob (default 0.25).  The JAX package
    folds every sublist's weight into the one flat knob, so the block
    read last set it for Auv and ATS both (ROADMAP queue 3)."""
    if params.is_sublist(blk + " Solver"):
        w = params.sublist(blk + " Solver").get("MG prolongation weight",
                                                -1.0)
        if w >= 0:
            return float(w)
    return float(params.get("MG prolongation weight"))


def preconditioner_params(params: ParameterList | dict | None
                          ) -> ParameterList:
    """The Preconditioner list as the methods read it: the defaults of
    :func:`default_prec_params` set where it names nothing, and the
    nested per-block sublists folded into the flat knobs."""
    if params is None:
        params = ParameterList("Preconditioner")
    if isinstance(params, dict):
        params = ParameterList("Preconditioner", params)
    params.validate_and_set_defaults(default_prec_params())
    _apply_nested_block_lists(params)
    return params


def bgs_options(params: ParameterList) -> tuple[dict, dict]:
    """(build_kw, apply_kw): ``bgs.build``'s and ``bgs.apply``'s keywords
    of a list from :func:`preconditioner_params`, each block's MG
    prolongation weight its own.  The serial and the sharded BGS solves
    both read them here."""
    build_kw = dict(
        spp_scheme=params.get("Saddlepoint scheme"),
        rhomu=bool(params.get("ATS rho/mu Transform")),
        rhomu_lambda=float(params.get("rho/mu lambda")),
        uv_precond=params.get("Auv Precond"),
        ts_precond=params.get("ATS Precond"),
        spp_precond=params.get("Saddlepoint Precond"),
        **{kw: _prolongation_weight(params, blk) for kw, blk in (
            ("spp_prolong_w", "Saddlepoint"), ("uv_prolong_w", "Auv"),
            ("ts_prolong_w", "ATS"))})
    apply_kw = dict(
        nit_spp=params.get("Saddlepoint iterations"),
        nit_uv=params.get("Auv iterations"),
        nit_ts=params.get("ATS iterations"),
        spp_scheme=params.get("Saddlepoint scheme"),
        permutation=int(params.get("Permutation")),
        symmetric=params.get("Scheme") == "symmetric Gauss-Seidel",
        tol_spp=float(params.get("Saddlepoint tolerance")),
        tol_uv=float(params.get("Auv tolerance")),
        tol_ts=float(params.get("ATS tolerance")))
    return build_kw, apply_kw


def make_preconditioner(params: ParameterList | dict | None, *,
                        landm: np.ndarray, periodic: bool,
                        grid_shape: tuple[int, int, int],
                        int_row_provider: Callable | None = None
                        ) -> tuple[Callable, Callable]:
    """Return (build, apply) closures for the configured method.

    int_row_provider: optional () -> (coeff, (var,k,j,i), scale) for the
    salinity integral-condition row, evaluated at build time; consumed
    by BGS."""
    params = preconditioner_params(params)
    method = params.get("Method")

    if method == "None":
        return (lambda An: None), (lambda fac, r: r)

    if method == "Columns":
        from .preconditioner import build_column_blocks, apply_column_prec
        return build_column_blocks, apply_column_prec

    if method == "BGS":
        from . import bgs
        build_kw, apply_kw = bgs_options(params)

        def build(An):
            int_row = (int_row_provider()
                       if int_row_provider is not None else None)
            return bgs.build(An, landm, periodic=periodic, int_row=int_row,
                             **build_kw)

        graphs = None       # of the factor set applied last on the card

        def apply(fac, r):
            nonlocal graphs
            if not r.is_cuda:
                return bgs.apply(fac, r, periodic=periodic, **apply_kw)
            if graphs is None or graphs.prec is not fac:
                graphs = bgs.SweepGraphs(fac)
            return bgs.apply(fac, r, periodic=periodic, graphs=graphs,
                             **apply_kw)

        return build, apply

    if method == "Teko":
        # the experimental Teko/Rearranger path: block-GS over the
        # ([u,v,w,p] | [T,S]) groups with column inverses per group
        from . import rearranger
        sweeps = params.get("Teko sweeps")

        def build(An):
            return rearranger.build(An, periodic=periodic)

        def apply(fac, r):
            return rearranger.apply(fac, r, periodic=periodic,
                                    sweeps=sweeps)

        return build, apply

    if method == "Amesos":
        # sparse-direct factorization of the assembled CSR matrix (the
        # reference's Ifpack Amesos_Klu option)
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        def build(An):
            data, indices, indptr = stencil_to_csr(An, periodic=periodic)
            N = len(indptr) - 1
            A = sp.csr_matrix((data, indices, indptr), shape=(N, N))
            # the ocean Jacobian is exactly singular along the pressure
            # checkerboard modes, where an LU of the exact matrix returns
            # O(1/eps) garbage; a relative 1e-10 diagonal shift caps the
            # null-space gain (the outer FGMRES deflates those modes)
            shift = 1e-10 * float(np.abs(data).max())
            return spla.splu((A + shift * sp.identity(N, format="csr"))
                             .tocsc())

        def apply(fac, r):
            return _host_solve(fac.solve, r)

        return build, apply

    if method == "MILU":
        from ..native import milu
        droptol = params.get("MILU drop tolerance")
        maxlev = params.get("MILU max levels")
        fill = params.get("MILU fill factor")

        def build(An):
            data, indices, indptr = stencil_to_csr(An, periodic=periodic)
            return milu.factor(data, indices, indptr, droptol=droptol,
                               max_levels=maxlev, fill_factor=fill)

        def apply(fac, r):
            return _host_solve(fac.solve, r)

        return build, apply

    raise ValueError(f"SolverFactory: unknown method '{method}'")


def _host_solve(solve: Callable, r: torch.Tensor) -> torch.Tensor:
    """z = solve(r) for a host-side factorization: r (6, l, m, n) goes to
    the host in the flat row ordering of the CSR matrix, f64, and the
    result comes back on r's device in r's dtype."""
    _, l, m, n = r.shape
    z = solve(to_flat(r).detach().cpu().numpy().astype(np.float64))
    return from_flat(torch.as_tensor(z, dtype=r.dtype, device=r.device),
                     l, m, n)


def make_krylov(solver_params: ParameterList | dict | None = None):
    """Krylov solver construction (TRIOS_SolverFactory.C:65-250): returns
    a host-driven ``solve(matvec, b, prec)`` closure configured from the
    list.  FGMRES returns (x, FGMRESResult), IDR an IDRResult, as in the
    JAX package."""
    from .fgmres import fgmres_host
    from .idr import idr_host

    sp = solver_params or {}
    if isinstance(sp, ParameterList):
        sp = sp.to_dict()
    method = sp.get("Method", "FGMRES")
    tol = sp.get("Tolerance", 1e-8)
    maxiter = sp.get("Max iterations", 200)
    s = sp.get("IDR s", 4)

    if method == "FGMRES":
        def solve(matvec, b, prec=None):
            return fgmres_host(matvec, b, prec=prec, tol=tol,
                               maxiter=maxiter)
        return solve
    if method == "IDR":
        def solve(matvec, b, prec=None):
            return idr_host(matvec, b, prec=prec, tol=tol,
                            maxiter=maxiter, s=s)
        return solve
    raise ValueError(f"SolverFactory: unknown Krylov method '{method}'")


def spectrum_analysis(matvec: Callable, prec: Callable, N: int, *,
                      nsample: int = 40, seed: int = 0,
                      device="cuda") -> np.ndarray:
    """Estimate the spectrum of P^{-1} A by Arnoldi Ritz values, to judge
    a preconditioner offline.  matvec and prec map flat f64 tensors on
    device to flat tensors; the start vector comes from
    ``np.random.default_rng(seed)``.  The Arnoldi basis lives on device:
    the card unless the caller asks for the CPU, as for Ocean."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spectrum_analysis: device cuda but no CUDA "
                           "device (pass device=\"cpu\" to run on the CPU)")
    rng = np.random.default_rng(seed)
    k = min(nsample, N - 1)
    V = torch.zeros((N, k + 1), dtype=torch.float64, device=device)
    H = np.zeros((k + 1, k))
    v0 = rng.standard_normal(N)
    V[:, 0] = torch.as_tensor(v0 / np.linalg.norm(v0), device=device)
    ncols = 0
    for j in range(k):
        w = prec(matvec(V[:, j]).reshape(-1)).reshape(-1).to(torch.float64)
        for i in range(j + 1):
            H[i, j] = float(V[:, i] @ w)
            w = w - H[i, j] * V[:, i]
        H[j + 1, j] = float(torch.linalg.norm(w))
        ncols = j + 1
        if H[j + 1, j] < 1e-12:
            break
        V[:, j + 1] = w / H[j + 1, j]
    ritz = np.linalg.eigvals(H[:ncols, :ncols])
    log.INFO(f"spectrum_analysis: {ncols} Ritz values, "
             f"|lambda| in [{np.abs(ritz).min():.2e}, "
             f"{np.abs(ritz).max():.2e}]")
    return ritz
