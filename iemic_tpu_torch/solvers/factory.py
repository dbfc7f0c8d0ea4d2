"""Solver / preconditioner factory (PyTorch).

Port of ``iemic_tpu/solvers/factory.py`` (the reference's
TRIOS::SolverFactory, TRIOS_SolverFactory.C:65-250): dispatch on a
"Method" name, returning (build, apply) closures with the contract

    build(An)         -> factors
    apply(factors, r) -> z ~= J^{-1} r

Methods ported: "None", "Columns" and "BGS".
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..config import ParameterList


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
            if sl.get("MG prolongation weight", -1.0) >= 0:
                params.set("MG prolongation weight",
                           float(sl.get("MG prolongation weight")))


def make_preconditioner(params: ParameterList | dict | None, *,
                        landm: np.ndarray, periodic: bool,
                        grid_shape: tuple[int, int, int],
                        int_row_provider: Callable | None = None
                        ) -> tuple[Callable, Callable]:
    """Return (build, apply) closures for the configured method.

    int_row_provider: optional () -> (coeff, (var,k,j,i), scale) for the
    salinity integral-condition row, evaluated at build time; consumed
    by BGS."""
    if params is None:
        params = ParameterList("Preconditioner")
    if isinstance(params, dict):
        params = ParameterList("Preconditioner", params)
    params.validate_and_set_defaults(default_prec_params())
    _apply_nested_block_lists(params)
    method = params.get("Method")

    if method == "None":
        return (lambda An: None), (lambda fac, r: r)

    if method == "Columns":
        from .preconditioner import build_column_blocks, apply_column_prec
        return build_column_blocks, apply_column_prec

    if method == "BGS":
        from . import bgs
        build_kw = dict(
            spp_scheme=params.get("Saddlepoint scheme"),
            rhomu=bool(params.get("ATS rho/mu Transform")),
            uv_precond=params.get("Auv Precond"),
            ts_precond=params.get("ATS Precond"),
            spp_precond=params.get("Saddlepoint Precond"),
            prolong_w=float(params.get("MG prolongation weight")))
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

    if method in ("Teko", "Amesos", "MILU"):
        raise NotImplementedError(
            f"preconditioner '{method}': ROADMAP queue 1 item 13 "
            "(remaining solvers)")
    raise ValueError(f"SolverFactory: unknown method '{method}'")
