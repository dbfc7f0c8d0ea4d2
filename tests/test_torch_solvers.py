"""Port parity of the solver layer outside the BGS sweep against the JAX
package, on the CPU in f64 from the same numpy inputs: IDR(s), the
Rearranger and its Teko sweep, the MILU bridge, the host-side methods of
the factory (MILU, Amesos) alone and through ``Ocean.solve``,
``make_krylov``, ``spectrum_analysis`` and ``make_deflator``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.native import milu as jmilu
from iemic_tpu.ops.stencil import stencil_to_csr as jcsr
from iemic_tpu.solvers import factory as jfactory
from iemic_tpu.solvers import idr as jidr
from iemic_tpu.solvers import preconditioner as jprec
from iemic_tpu.solvers import rearranger as jre

from iemic_tpu_torch import interop
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.native import milu as tmilu
from iemic_tpu_torch.ops.stencil import apply_stencil, stencil_to_csr
from iemic_tpu_torch.solvers import factory as tfactory
from iemic_tpu_torch.solvers import idr as tidr
from iemic_tpu_torch.solvers import preconditioner as tprec
from iemic_tpu_torch.solvers import rearranger as tre

from test_torch_ocean import CASES, DATA, _close


def _dense_operator(n=60, seed=0):
    """A nonsymmetric, diagonally dominant dense operator, its diagonal
    as preconditioner, and a right-hand side."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) + np.diag(n * (1.0 + rng.random(n)))
    return A, np.diag(A).copy(), rng.standard_normal(n)


def _both_callables(A, d):
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    return ((lambda v: Aj @ v, lambda v: v / dj),
            (lambda v: At @ v, lambda v: v / dt))


@pytest.mark.parametrize("smoothing", [True, False])
@pytest.mark.parametrize("s", [1, 4])
def test_idr_matches_jax(s, smoothing):
    """Same shadow space (rng(seed)), so the same iterates: x to 1e-10
    relative (measured 2e-15), relres to 1e-10 of itself, iterations
    equal."""
    A, d, b = _dense_operator()
    (mvj, pcj), (mvt, pct) = _both_callables(A, d)
    kw = dict(s=s, tol=1e-10, maxiter=100, smoothing=smoothing)
    rj = jidr.idr_host(mvj, jnp.asarray(b), prec=pcj, **kw)
    rt = tidr.idr_host(mvt, torch.as_tensor(b), prec=pct, **kw)
    assert rt.converged and rj.converged
    assert rt.iters == rj.iters
    _close(rt.x.numpy(), rj.x, 1e-10)
    assert abs(rt.relres - rj.relres) <= 1e-10 * max(rj.relres, 1e-300) \
        or abs(rt.relres - rj.relres) < 1e-20
    assert np.linalg.norm(A @ rt.x.numpy() - b) <= 1e-9 * np.linalg.norm(b)


def test_idr_zero_rhs_and_budget():
    """b = 0 returns at once; a budget too small reports no
    convergence."""
    A, d, b = _dense_operator()
    At = torch.as_tensor(A)
    r0 = tidr.idr_host(lambda v: At @ v, torch.zeros(60, dtype=torch.float64))
    assert r0.converged and r0.iters == 0
    r1 = tidr.idr_host(lambda v: At @ v, torch.as_tensor(b), maxiter=3,
                       tol=1e-14)
    assert not r1.converged and r1.iters == 3


@pytest.mark.parametrize("method", ["FGMRES", "IDR"])
def test_make_krylov_matches_jax(method):
    """make_krylov's closure for both methods against the JAX package's:
    x to 1e-10 (measured 1e-15)."""
    A, d, b = _dense_operator(seed=1)
    (mvj, pcj), (mvt, pct) = _both_callables(A, d)
    pars = {"Method": method, "Tolerance": 1e-10, "Max iterations": 80,
            "IDR s": 2}
    outj = jfactory.make_krylov(dict(pars))(mvj, jnp.asarray(b), pcj)
    outt = tfactory.make_krylov(dict(pars))(mvt, torch.as_tensor(b), pct)
    if method == "FGMRES":
        (xj, resj), (xt, rest) = outj, outt
    else:
        (xj, resj), (xt, rest) = (outj.x, outj), (outt.x, outt)
    assert rest.converged and rest.iters == resj.iters
    _close(xt.numpy(), xj, 1e-10)
    with pytest.raises(ValueError, match="unknown Krylov method"):
        tfactory.make_krylov({"Method": "CG"})


def test_fgmres_on_shaped_tensors_matches_jax():
    """fgmres on a (6, 10) right-hand side with a start vector, against
    the JAX package's pytree entry: x to 1e-10 (measured 2e-14),
    iterations equal."""
    from iemic_tpu.solvers.fgmres import fgmres as jfgmres
    from iemic_tpu_torch.solvers.fgmres import fgmres as tfgmres
    A, d, b = _dense_operator(seed=6)
    (mvj, pcj), (mvt, pct) = _both_callables(A, d)
    x0 = np.random.default_rng(7).standard_normal(60)
    shaped = lambda f: (lambda v: f(v.reshape(-1)).reshape(6, 10))  # noqa
    xj, rj = jfgmres(shaped(mvj), jnp.asarray(b.reshape(6, 10)),
                     jnp.asarray(x0.reshape(6, 10)), prec=shaped(pcj),
                     tol=1e-10, maxiter=60)
    xt, rt = tfgmres(shaped(mvt), torch.as_tensor(b.reshape(6, 10)),
                     torch.as_tensor(x0.reshape(6, 10)), prec=shaped(pct),
                     tol=1e-10, maxiter=60)
    assert xt.shape == (6, 10) and rt.converged
    assert rt.iters == int(rj.iters)
    _close(xt.numpy(), xj, 1e-10)
    xn, rn = tfgmres(shaped(mvt), torch.as_tensor(b.reshape(6, 10)),
                     tol=1e-10, maxiter=60)
    assert rn.converged
    assert np.linalg.norm(A @ xn.numpy().reshape(-1) - b) \
        <= 1e-9 * np.linalg.norm(b)


def test_spectrum_analysis_matches_jax():
    """Arnoldi Ritz values of P^{-1} A from the same rng(seed) start, after
    8 steps on a nearly normal operator with a spread spectrum: to 1e-8
    relative (measured 2e-14).  The Ritz values of a clustered, nonnormal
    operator amplify the last-bit differences of the two packages'
    products (9e-9 after 8 steps, 1.2e-6 after 20, on _dense_operator)."""
    rng = np.random.default_rng(2)
    A = np.diag(np.linspace(1.0, 10.0, 60)) \
        + 0.01 * rng.standard_normal((60, 60))
    (mvj, pcj), (mvt, pct) = _both_callables(A, np.full(60, 2.0))
    rj = jfactory.spectrum_analysis(mvj, pcj, 60, nsample=8, seed=3)
    rt = tfactory.spectrum_analysis(mvt, pct, 60, nsample=8, seed=3,
                                    device="cpu")
    assert rj.shape == rt.shape == (8,)
    far = max(np.abs(rj - z).min() for z in rt)
    print(f"largest distance of a port Ritz value from JAX's {far:.3e}")
    assert far <= 1e-8 * np.abs(rj).max()
    if not torch.cuda.is_available():
        # the card is the default, and its absence is not passed over
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfactory.spectrum_analysis(mvt, pct, 60, nsample=8, seed=3)


def test_make_deflator_matches_jax():
    """The projector off two non-orthogonal vectors: to 1e-12; the
    projected vector is orthogonal to both."""
    rng = np.random.default_rng(4)
    nv = rng.standard_normal((2, 6, 3, 4, 5))
    v = rng.standard_normal((6, 3, 4, 5))
    pj = jprec.make_deflator(jnp.asarray(nv))(jnp.asarray(v))
    pt = tprec.make_deflator(torch.as_tensor(nv))(torch.as_tensor(v))
    assert pt.shape == v.shape
    _close(pt.numpy(), pj, 1e-12)
    assert np.abs(nv.reshape(2, -1) @ pt.numpy().reshape(-1)).max() < 1e-12


def _pair(method, **solver):
    """(jax ocean, torch ocean) on the island grid with preconditioner
    method, at the same random state, F and Jacobians computed."""
    sp = dict({"Preconditioning": method, "Precision": "Double",
               "FGMRES tolerance": 1e-8, "FGMRES iterations": 200}, **solver)
    jo = JOcean(CASES["island8x8x4"](), solver_params=dict(sp), data_dir=DATA)
    to = TOcean(CASES["island8x8x4"](), solver_params=dict(sp),
                data_dir=DATA, device="cpu")
    rng = np.random.default_rng(0)
    x = 0.05 * rng.standard_normal(np.shape(jo.state))
    x[4] += np.linspace(1.0, -1.0, x.shape[1])[:, None, None]
    jo.set_state(jnp.asarray(x))
    interop.install_state(to, x)
    for o in (jo, to):
        o.compute_rhs()
        o.compute_jacobian()
    return jo, to


def test_rearranger_blocks_tile_the_operator():
    """apply_blocked (the 10 physics blocks and the two dummy-row blocks)
    equals the full matvec, to round-off; the block pattern is the JAX
    package's."""
    jo, to = _pair("Teko")
    rt = tre.Rearranger(to.jac, periodic=False)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(to.state.shape)))
    full = apply_stencil(to.jac, x, periodic=False)
    _close(rt.apply_blocked(x).numpy(), full.numpy(), 1e-14)
    pj = jre.Rearranger(jo.jac, periodic=False).nonzero_pattern()
    pt = rt.nonzero_pattern()
    assert pt.keys() == pj.keys()
    for k in pj:
        assert abs(pt[k] - pj[k]) <= 1e-12 * max(pj[k], 1.0)
    y = rt.block("G_uv")(x[[3]])
    _close(y.numpy(), jre.Rearranger(jo.jac, periodic=False).block("G_uv")(
        jnp.asarray(x.numpy()[[3]])), 1e-12)


@pytest.mark.parametrize("sweeps", [1, 2])
def test_teko_sweep_matches_jax(sweeps):
    """One and two Teko block-GS sweeps: to 1e-10 (measured 2e-15)."""
    jo, to = _pair("Teko")
    r = np.random.default_rng(2).standard_normal(np.shape(jo.state))
    zj = jre.apply(jre.build(jo.jac, periodic=False), jnp.asarray(r),
                   periodic=False, sweeps=sweeps)
    zt = tre.apply(tre.build(to.jac, periodic=False), torch.as_tensor(r),
                   periodic=False, sweeps=sweeps)
    _close(zt.numpy(), zj, 1e-10)


def test_milu_bridge_matches_jax_bridge():
    """factor and solve on the same CSR through the two bridges, which
    compile the same source: to 1e-13; and the port's library is its own
    file under build/, not the JAX bridge's native/libmilu.so."""
    jo, to = _pair("MILU")
    data, indices, indptr = stencil_to_csr(to.jac, periodic=False)
    dj, ij, pj = jcsr(np.asarray(jo.jac), periodic=False)
    np.testing.assert_array_equal(indices, ij)
    np.testing.assert_array_equal(indptr, pj)
    _close(data, dj, 1e-12)
    fj = jmilu.factor(data, indices, indptr, droptol=1e-3)
    ft = tmilu.factor(data, indices, indptr, droptol=1e-3)
    assert ft.levels == fj.levels and ft.n == fj.n
    b = np.random.default_rng(3).standard_normal(ft.n)
    _close(tmilu.solve(ft, b), jmilu.solve(fj, b), 1e-13)
    xt, itt, rrt = ft.gmres(b, tol=1e-6, maxiter=50)
    xj, itj, rrj = fj.gmres(b, tol=1e-6, maxiter=50)
    assert itt == itj
    _close(xt, xj, 1e-12)
    lib = tmilu.build()
    assert "build" in lib.split("/") and "libmilu-" in lib
    with pytest.raises(ValueError, match="size mismatch"):
        ft.solve(b[:-1])


@pytest.mark.parametrize("method", ["MILU", "Amesos", "Teko"])
def test_factory_method_matches_jax(method):
    """(build, apply) of make_preconditioner in the two packages on the
    same matrix, the JAX model's row-scaled Jacobian to the bit (MILU
    decides what to drop on the last bits of an entry): one application to
    1e-9 (measured 0 MILU, 1e-10 Amesos: two sparse LUs of a matrix
    shifted by 1e-10; 7e-14 Teko); the host crossing returns the
    residual's dtype."""
    jo, to = _pair(method)
    jo._get_prec_factors()
    An = np.asarray(jo._jac_s)
    kw = dict(landm=np.asarray(jo.landm), periodic=False,
              grid_shape=(4, 8, 8))
    bj, aj = jfactory.make_preconditioner({"Method": method}, **kw)
    bt, at = tfactory.make_preconditioner({"Method": method}, **kw)
    fj, ft = bj(jnp.asarray(An)), bt(interop.stencil(An, "cpu"))
    r = np.random.default_rng(5).standard_normal(np.shape(jo.state))
    zj = aj(fj, jnp.asarray(r))
    zt = at(ft, torch.as_tensor(r))
    assert zt.dtype == torch.float64 and zt.shape == to.state.shape
    _close(zt.numpy(), zj, 1e-9)
    if method != "Teko":
        z32 = at(ft, torch.as_tensor(r, dtype=torch.float32))
        assert z32.dtype == torch.float32
        _close(z32.double().numpy(), zj, 1e-5)


@pytest.mark.parametrize("method,precision", [("Amesos", "Mixed"),
                                              ("Amesos", "Double"),
                                              ("MILU", "Mixed")])
def test_host_preconditioned_solve_matches_jax(method, precision):
    """Ocean.solve with a host-side preconditioner takes the host-driven
    f64 FGMRES whatever the precision asked, and meets the tolerance (1e-6)
    on its true residual.  Amesos: iteration counts equal (1) and the
    solution to 1e-5 relative (measured 2e-9).  MILU: the two packages'
    row-scaled Jacobians differ in last bits, so their factors drop other
    entries: 380 against 382 iterations (held within 5), and the two
    solutions of this ill-conditioned system, each to 1e-6 in the
    residual, lie 2.1e-4 apart (limit 1e-3)."""
    tol = 1e-6
    jo, to = _pair(method, **{"Precision": precision,
                              "FGMRES tolerance": tol,
                              "FGMRES iterations": 400})
    assert to._prec_host_only
    xj = np.asarray(jo.solve(-jo.rhs))
    xt = to.solve(-to.rhs)
    far = np.abs(xt.numpy() - xj).max() / np.abs(xj).max()
    print(f"{method}: iterations port {to.solve_iters} jax {jo.solve_iters}, "
          f"relres port {to.solve_relres:.3e} jax {jo.solve_relres:.3e}, "
          f"solutions {far:.3e} apart")
    if method == "Amesos":
        assert to.solve_iters == jo.solve_iters
        assert far <= 1e-5
    else:
        assert abs(to.solve_iters - jo.solve_iters) <= 5
        assert far <= 1e-3
    assert to.solve_relres <= tol
    r = (to.apply_matrix(xt) + to.rhs) * to._rowscale
    assert float(r.norm() / (to.rhs * to._rowscale).norm()) <= 2 * tol


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method 'ILUT'"):
        tfactory.make_preconditioner({"Method": "ILUT"}, landm=np.zeros(
            (6, 10, 10)), periodic=False, grid_shape=(4, 8, 8))
