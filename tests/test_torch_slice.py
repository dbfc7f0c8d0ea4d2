"""Port parity of the whole slice: a 2-step pseudo-arclength
continuation of the 2DMOC fixture through the production solver stack
(BGS preconditioner, Mixed precision, and the same with Double) in the
JAX package and in the port, on CPU; and the port's import hygiene."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_continuation_2dmoc import CONT_PARS, make_2dmoc_ocean
from iemic_tpu.continuation import Continuation as JContinuation
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.continuation import Continuation as TContinuation
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.utils import logging as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOLVER = {"Preconditioning": "BGS", "Precision": "Mixed",
          "FGMRES tolerance": 1e-3, "FGMRES iterations": 200}
DOUBLE = dict(SOLVER, Precision="Double")


def _cdata(path):
    rows = [line.split() for line in open(path) if not line.startswith("#")]
    return np.array([[float(v) for v in r] for r in rows])


def _run(make, cont_cls, log, cdata_path):
    log.set_cdata_file(str(cdata_path))
    model = make()
    pars = dict(CONT_PARS)
    pars["maximum number of steps"] = 2
    try:
        result = cont_cls(model, pars).run()
    finally:
        log.set_cdata_file(None)
    return model, result, _cdata(cdata_path)


def _both(tmp, solver):
    """The 2-step continuation in the JAX package and in the port; the
    JAX model gets the port's per-solve (MV, relres) log."""
    def make_jax():
        o = make_2dmoc_ocean()
        for k, v in solver.items():
            o.solver_params.set(k, v)
        o._build_jitted()
        o.solve_log = []
        solve = o.solve

        def logged(b):
            x = solve(b)
            o.solve_log.append((int(o.solve_iters), float(o.solve_relres)))
            return x
        o.solve = logged
        return o

    def make_torch():
        return TOcean({"THCM": _thcm_dict()}, solver_params=dict(solver),
                      device="cpu")

    return (_run(make_jax, JContinuation, jlog, tmp / "jax.txt"),
            _run(make_torch, TContinuation, tlog, tmp / "torch.txt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _both(tmp_path_factory.mktemp("slice"), SOLVER)


@pytest.fixture(scope="module")
def double_runs(tmp_path_factory):
    return _both(tmp_path_factory.mktemp("slice_double"), DOUBLE)


def _thcm_dict():
    """The fixture's THCM list, read back from the JAX fixture."""
    return make_2dmoc_ocean().params.sublist("THCM").to_dict()


def test_slice_matches_jax(runs):
    """cdata columns: par to 1e-8, NR equal, the final state to 1e-6.

    MV (the f32-preconditioned Krylov count of the last solve of a
    step) is not compared solve by solve: the f32 BGS sweep runs its
    60-iteration inner saddle FGMRES past the f32 noise floor, where the
    JAX package's own f32 sweep is as far from its f64 sweep as the
    port's is (test_torch_ocean.py::test_f32_sweep_gap_is_jax_own), and
    the counts then differ chaotically (measured 111 against 577 and 378
    against 471 on this fixture).  Every port solve is instead held to
    the requested tolerance on its true f64 residual, and MV is held
    solve by solve on the Double stack (test_double_slice_matches_jax),
    whose sweeps agree."""
    (jo, jres, jc), (to, tres, tc) = runs
    assert jres.status == 0 and tres.status == 0
    assert jc.shape == tc.shape == (2, 8)
    np.testing.assert_allclose(tc[:, 0], jc[:, 0], rtol=1e-8)      # par
    np.testing.assert_array_equal(tc[:, 4], jc[:, 4])             # NR
    xj = np.asarray(jo.state)
    xt = to.state.numpy()
    assert np.abs(xt - xj).max() <= 1e-6 * np.abs(xj).max()
    assert all(relres <= SOLVER["FGMRES tolerance"]
               for _, relres in to.solve_log)
    assert tc[:, 5].min() > 0                                       # MV


def test_double_slice_matches_jax(double_runs):
    """The same continuation with Precision=Double, where the two
    packages' BGS sweeps agree to 4e-6 (test_torch_ocean.py): par to
    1e-8, NR equal, MV within 2 solve by solve, the final state to
    1e-6."""
    (jo, jres, jc), (to, tres, tc) = double_runs
    assert jres.status == 0 and tres.status == 0
    assert jc.shape == tc.shape == (2, 8)
    np.testing.assert_allclose(tc[:, 0], jc[:, 0], rtol=1e-8)      # par
    np.testing.assert_array_equal(tc[:, 4], jc[:, 4])             # NR
    assert len(to.solve_log) == len(jo.solve_log) > 0
    mv_t = np.array([mv for mv, _ in to.solve_log])
    mv_j = np.array([mv for mv, _ in jo.solve_log])
    assert np.abs(mv_t - mv_j).max() <= 2, (mv_t, mv_j)
    assert np.abs(tc[:, 5] - jc[:, 5]).max() <= 2                  # MV
    xj = np.asarray(jo.state)
    xt = to.state.numpy()
    assert np.abs(xt - xj).max() <= 1e-6 * np.abs(xj).max()
    assert all(relres <= DOUBLE["FGMRES tolerance"]
               for _, relres in to.solve_log)


def test_port_never_imports_jax():
    modules = ["iemic_tpu_torch", "iemic_tpu_torch.main.run_ocean",
               "iemic_tpu_torch.main.time_ocean",
               "iemic_tpu_torch.main.run_ams",
               "iemic_tpu_torch.interop", "iemic_tpu_torch.ops.stencil_hopper",
               "iemic_tpu_torch.native.milu",
               "iemic_tpu_torch.models.ocean.diagnostics",
               "iemic_tpu_torch.utils.numjac",
               "iemic_tpu_torch.utils.hashing",
               "iemic_tpu_torch.models.ocean.analysis",
               "iemic_tpu_torch.topo", "iemic_tpu_torch.topo.topo",
               "iemic_tpu_torch.lyapunov", "iemic_tpu_torch.lyapunov.rails",
               "iemic_tpu_torch.lyapunov.model", "iemic_tpu_torch.post",
               "iemic_tpu_torch.post.masks",
               "iemic_tpu_torch.main.run_topo",
               "iemic_tpu_torch.main.run_lyapunov",
               "iemic_tpu_torch.models.atmosphere",
               "iemic_tpu_torch.models.seaice",
               "iemic_tpu_torch.models.coupled",
               "iemic_tpu_torch.main.run_coupled",
               "iemic_tpu_torch.main.time_coupled",
               "iemic_tpu_torch.post.readers",
               "iemic_tpu_torch.post.transports",
               "iemic_tpu_torch.post.plotting", "chip_smoke"] + [
        "iemic_tpu_torch.solvers." + name for name in (
            "bgs", "eigen", "factory", "fgmres", "idr", "mg",
            "preconditioner", "rearranger", "saddlepoint")] + [
        "iemic_tpu_torch.transient." + name for name in (
            "theta", "newton", "adaptive", "transient", "score", "factory")]
    code = (f"import sys, {', '.join(modules)}; "
            "print('jax' in sys.modules or 'iemic_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"
