"""Port parity on the production grid: the first Newton solves of
run/ocean/global (masked global 96x38x12) in the JAX package and in the
port, on CPU in f64 (Preconditioning = BGS, Precision = Double).

The point compared is the predictor of the bundle's first continuation
step (par = 3.675e-2, |F| = 128.7 with f64 solves), where the
BGS-preconditioned solves slow down against the bundle's initial state
(2 iterations there).  Both packages compute F and the Jacobian from the
same numpy state, build the preconditioner and run the two FGMRES
solves of the corrector's first iteration, J y = dF/dpar and J z = -F,
capped at CAP iterations.

Slow (23 minutes on eight CPU cores), outside tier-1:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_global.py -m slow -s
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
from iemic_tpu import config as jconfig
from iemic_tpu.continuation import Continuation as JContinuation
from iemic_tpu.main import run_ocean as jrun
from iemic_tpu.models.ocean import Ocean as JOcean

from iemic_tpu_torch import config as tconfig
from iemic_tpu_torch.continuation import Continuation as TContinuation
from iemic_tpu_torch.main import run_ocean as trun
from iemic_tpu_torch.models.ocean import Ocean as TOcean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, "run", "ocean", "global")
TOL = 1e-3          # FGMRES tolerance of both solves
CAP = 10            # "FGMRES iterations": where the Newton solve is read


def _build(config, run, ocean_cls, cont_cls, **kw):
    """Ocean and Continuation of the bundle (cwd), Double, capped."""
    sp = run.read_solver_params()
    sp.set("Precision", "Double")
    sp.set("Preconditioning", "BGS")
    sp.set("FGMRES tolerance", TOL)
    sp.set("FGMRES iterations", CAP)
    op = config.read_xml("ocean_params.xml")
    op.set("Save state", False)
    ocean = ocean_cls(op, solver_params=sp, **kw)
    return ocean, cont_cls(ocean, config.read_xml("continuation_params.xml"))


def _to_predictor(cont):
    """The bundle's start up to the first step's Euler predictor, as
    Continuation.run does it; returns the tangent solve's (MV, relres)."""
    m = cont.model
    cont.initialize()
    cont.create_initial_tangent()
    tangent = (int(m.solve_iters), float(m.solve_relres))
    cont.step_ = 1
    cont.store()
    m.pre_process()
    assert cont.euler_predictor() == 0
    return tangent


def _relmax(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.slow
def test_first_newton_solves_match_jax(monkeypatch):
    monkeypatch.chdir(BUNDLE)
    to, tcont = _build(tconfig, trun, TOcean, TContinuation, device="cpu")
    jo, jcont = _build(jconfig, jrun, JOcean, JContinuation)
    assert np.array_equal(np.asarray(jo.landm), to.landm)

    # the initial tangent solve and the predictor, each package its own
    ttan = _to_predictor(tcont)
    jtan = _to_predictor(jcont)
    print(f"tangent solve (MV, relres): port {ttan}, JAX {jtan}")
    print(f"predictor par: port {tcont.par:.8e}, JAX {jcont.par:.8e}")
    assert ttan[0] == jtan[0] and ttan[1] < TOL and jtan[1] < TOL
    assert abs(tcont.par - jcont.par) <= 1e-6 * abs(jcont.par)
    # both solves stop anywhere below TOL, so the predictor states agree
    # to about TOL only
    dpred = _relmax(to.state.numpy(), jo.state)
    print(f"predictor state, port against JAX: {dpred:.3e}")
    assert dpred <= 10 * TOL

    # from here on both packages work on the port's predictor point
    x = to.state.numpy().copy()
    jo.set_state(jnp.asarray(x))
    jo.set_par(jcont.par_name, tcont.par)
    np.testing.assert_array_equal(np.asarray(jo.par), to.par.numpy())

    # the corrector's first iteration, as Continuation.newton_corrector
    # does it: F and dF/dpar, the Jacobian, then J y = dF/dpar and
    # J z = -F
    tcont.compute_dfdpar("F")
    jcont.compute_dfdpar("F")
    to.compute_jacobian()
    jo.compute_jacobian()
    ef = _relmax(tcont.rhs_copy.numpy(), jcont.rhs_copy)
    ed = _relmax(tcont.dfdpar.numpy(), jcont.dfdpar)
    ea = _relmax(to.jac.numpy(), jo.jac)
    fnorm = float(np.linalg.norm(np.asarray(jcont.rhs_copy)))
    print(f"|F| = {fnorm:.4e}; F parity {ef:.3e}, An parity {ea:.3e} "
          f"(limit 1e-12), dF/dpar parity {ed:.3e} (limit 1e-8)")
    assert ef <= 1e-12 and ea <= 1e-12
    # a forward difference with epsilon 1e-6 of values that agree to 1e-15
    assert ed <= 1e-8

    # both packages solve for the port's right-hand sides
    got = {}
    for name, b in (("dF/dpar", tcont.dfdpar), ("-F", -tcont.rhs_copy)):
        to.solve(b)
        jo.solve(jnp.asarray(b.numpy()))
        tres = (int(to.solve_iters), float(to.solve_relres))
        jres = (int(jo.solve_iters), float(jo.solve_relres))
        dsol = _relmax(to.sol.numpy(), jo.sol)
        print(f"J x = {name} capped at {CAP} (MV, relres): port {tres}, "
              f"JAX {jres}; solutions differ by {dsol:.3e}")
        got[name] = (tres, jres)
    for tres, jres in got.values():
        assert tres[0] == jres[0]
        assert 0.5 <= tres[1] / jres[1] <= 2.0
    # what the comparison is for: the solve for dF/dpar is the one that
    # slows down at this point, in both packages alike, while the solve
    # for -F does not
    assert got["dF/dpar"][1][0] == CAP
    assert got["dF/dpar"][1][1] > TOL > got["-F"][1][1]
