"""ShardedOcean's solve is Ocean.solve's (iemic_tpu_torch/parallel/model.py
and halo.py's make_sharded_solve), on the CPU.

The JAX package's sharded continuation is ``Continuation`` on an ``Ocean``
with a sharded state (``__graft_entry__.py:240-287``,
``tests/test_parallel.py:244-306``), so each of its solves is
``Ocean.solve`` with the whole Preconditioner sublist.  The port's
``ShardedOcean`` reads that sublist with the serial factory's own parser
(``factory.bgs_options``), row-scales the BGS/Double system where
``Ocean`` does, and runs ``Ocean``'s Mixed refinement.  On one rank
without a process group its solve is then ``Ocean.solve`` iteration for
iteration (measured: the same MV and iterate, gap 0, on the 8x8x4
fixture; before the repair the sharded Double solve stalled at 200 MV and
the Mixed one took thousands of MV).  A method the sharded solve does not
run raises ValueError naming it.  The four-rank solves on default
settings are slow tests (four gloo ranks on default settings take
minutes on the CPU).
"""

import copy
import os

import numpy as np
import pytest
import torch

from iemic_tpu_torch.config import read_xml
from iemic_tpu_torch.main import multichip
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.parallel import Domain, ShardedOcean
from iemic_tpu_torch.solvers import bgs as tbgs
from iemic_tpu_torch.solvers import factory as tfactory
from iemic_tpu_torch.utils import logging as tlog

# the 8x8x4 periodic fixture of tests/test_torch_parallel_continuation.py
# (tests/test_parallel.py:48-78) at a random state (0.01, seed 11)
THCM = {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Periodic": True,
        "Starting Parameters": {"Combined Forcing": 0.3,
                                "Temperature Forcing": 10.0,
                                "Wind Forcing": 1.0}}
SEED = 11
# the default solver parameters (BGS, 200 FGMRES iterations, the default
# Preconditioner sublist) at FGMRES tolerance TOL
TOL = 1e-8
# the one-rank sharded iterate against Ocean.solve's, relative to its
# largest entry
SAME_X = 1e-10
BUNDLE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "run",
                      "ocean", "global")
# a Preconditioner list that sets every BGS option away from its default,
# through the flat knobs and the nested per-block sublists
NESTED = {"Saddlepoint scheme": "SL", "ATS rho/mu Transform": True,
          "rho/mu lambda": 3.0, "Permutation": 2,
          "Scheme": "symmetric Gauss-Seidel", "MG prolongation weight": 0.1,
          "Auv Solver": {"Iterations": 3, "Tolerance": 1e-3,
                         "Precond Method": "MG",
                         "MG prolongation weight": 0.5},
          "Saddlepoint Solver": {"Scheme": "KRYLOV", "Iterations": 7,
                                 "Precond Method": "MG"},
          "ATS Solver": {"Iterations": 2, "Tolerance": 1e-4,
                         "Precond Method": "Columns"}}
# make_preconditioner's keywords to bgs.build and bgs.apply of the lists
# above, as the factory passed them before the parser was shared
DEFAULT_KW = (
    {"spp_scheme": "SI", "rhomu": False, "rhomu_lambda": 7.6e-4 / 1.8e-4,
     "uv_precond": "Columns", "ts_precond": "MG", "spp_precond": "Jacobi",
     "spp_prolong_w": 0.25, "uv_prolong_w": 0.25, "ts_prolong_w": 0.25},
    {"nit_spp": 60, "nit_uv": 12, "nit_ts": 0, "spp_scheme": "SI",
     "permutation": 1, "symmetric": False, "tol_spp": 1e-8, "tol_uv": 1e-2,
     "tol_ts": 1e-2})
NESTED_KW = (
    {"spp_scheme": "KRYLOV", "rhomu": True, "rhomu_lambda": 3.0,
     "uv_precond": "MG", "ts_precond": "Columns", "spp_precond": "MG",
     "spp_prolong_w": 0.1, "uv_prolong_w": 0.5, "ts_prolong_w": 0.1},
    {"nit_spp": 7, "nit_uv": 3, "nit_ts": 2, "spp_scheme": "KRYLOV",
     "permutation": 2, "symmetric": True, "tol_spp": 1e-8, "tol_uv": 1e-3,
     "tol_ts": 1e-4})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch and the BLAS and OpenMP pools on one thread in this module,
    as tests/test_torch_parallel.py does."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _quiet():
    tlog.set_verbose(False)
    yield
    tlog.set_verbose(True)


def _state():
    n, m, l = (THCM[f"Global Grid-Size {k}"] for k in "nml")
    return 0.01 * np.random.default_rng(SEED).standard_normal((6, l, m, n))


def _solver(precision):
    return {"Precision": precision, "FGMRES tolerance": TOL}


def _at_state(model):
    model.set_state(torch.as_tensor(_state()))
    model.compute_rhs()
    model.compute_jacobian()
    return model


def _ocean(solver):
    return TOcean({"THCM": dict(THCM)}, solver_params=copy.deepcopy(solver),
                  device="cpu")


def _sharded(solver):
    return ShardedOcean(_ocean(solver),
                        Domain(8, 8, 4, periodic=True, device="cpu"))


@pytest.mark.parametrize("precision", ["Double", "Mixed"])
def test_sharded_ocean_solve_is_ocean_solve(precision):
    """On one rank without a process group, at the default solver
    parameters, ShardedOcean.solve takes Ocean.solve's MV and iterate (to
    SAME_X) and meets the tolerance (the relres of the row-scaled system,
    as Ocean reports it)."""
    o = _at_state(_ocean(_solver(precision)))
    so = _at_state(_sharded(_solver(precision)))
    z, zs = o.solve(-o.rhs), so.solve(-so.rhs)
    gap = float((zs - z).abs().max() / z.abs().max())
    print(f"{precision}: Ocean.solve {o.solve_iters} MV to "
          f"{o.solve_relres:.2e}, ShardedOcean.solve {so.solve_iters} MV "
          f"to {so.solve_relres:.2e}, gap {gap:.1e}")
    assert so.solve_iters == o.solve_iters
    assert gap <= SAME_X
    assert so.solve_relres <= TOL and o.solve_relres <= TOL


@pytest.mark.parametrize("prec,expected", [
    ({}, DEFAULT_KW), ("bundle", DEFAULT_KW), (NESTED, NESTED_KW)])
def test_shared_parser_gives_the_factory_its_keywords(monkeypatch, prec,
                                                      expected):
    """make_preconditioner hands bgs.build and bgs.apply the keywords it
    handed them before factory.bgs_options was shared (the defaults,
    run/ocean/global's Preconditioner file, and a list with nested
    per-block sublists), and ShardedOcean reads the same from the same
    solver parameters."""
    if prec == "bundle":
        prec = read_xml(os.path.join(
            BUNDLE, "ocean_preconditioner_params.xml")).to_dict()
    got = {}
    monkeypatch.setattr(tbgs, "build",
                        lambda An, landm, **kw: got.update(build=kw))
    monkeypatch.setattr(tbgs, "apply",
                        lambda fac, r, **kw: got.update(apply=kw))
    build, apply = tfactory.make_preconditioner(
        dict(copy.deepcopy(prec), Method="BGS"), landm=np.zeros((6, 10, 10)),
        periodic=True, grid_shape=(4, 8, 8))
    apply(build(None), torch.zeros(1))
    for kw in got.values():
        kw.pop("periodic")
    got["build"].pop("int_row")
    assert (got["build"], got["apply"]) == expected
    so = _sharded({"Preconditioning": "BGS", "Precision": "Double",
                   "Preconditioner": copy.deepcopy(prec)})
    assert (so._build_opts, so._apply_opts) == expected


@pytest.mark.parametrize("solver,name", [
    ({"Preconditioning": "None"}, "None"),
    ({"Preconditioning": "Teko"}, "Teko"),
    ({"Preconditioning": "Amesos", "Precision": "Double"}, "Amesos"),
    ({"Preconditioning": "MILU"}, "MILU"),
    ({"Preconditioning": "BGS", "Preconditioner": {"Method": "Teko"}},
     "Teko"),
    ({"Preconditioning": "Columns", "Precision": "Mixed"}, "Columns")])
def test_refused_methods_raise_by_name(solver, name):
    """A method the sharded solve does not run, or Columns with Mixed,
    raises ValueError naming it when the ShardedOcean is made."""
    with pytest.raises(ValueError, match=f"Preconditioning '{name}'"):
        _sharded(solver)


def _true_relres(z) -> float:
    o = _at_state(_ocean(None))
    r = o.apply_matrix(torch.as_tensor(z)) + o.rhs
    return float(torch.linalg.norm(r) / torch.linalg.norm(o.rhs))


@pytest.mark.slow
@pytest.mark.parametrize("precision", ["Double", "Mixed"])
def test_four_rank_default_solve(precision):
    """ShardedOcean.solve on 2x2 gloo ranks at the default solver
    parameters: within its tolerance, the true (unscaled) residual of
    the gathered iterate within twice it, the same MV on every rank."""
    out = multichip.run_ranks(4, [("model_solve", dict(
        thcm=THCM, shape=(2, 2), solver=_solver(precision), x=_state()))],
        device="cpu", timeout_s=900.0)
    res = [r[0] for r in out]
    true = _true_relres(res[0]["z"])
    print(f"{precision} on 2x2: {res[0]['mv']} MV to {res[0]['relres']:.2e}, "
          f"true relres {true:.2e}, {res[0]['seconds']:.1f} s")
    assert all(r["mv"] == res[0]["mv"] for r in res)
    assert res[0]["relres"] <= TOL and true <= 2 * TOL
