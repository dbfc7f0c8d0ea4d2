"""Port parity of every branch of the BGS sweep against the JAX package:
one f64 sweep per branch from the factors of the same Jacobian, on the CPU
(masked 8x8x4 island grid, and 2DMOC for the rho/mu transform, whose ATS
block is the singular one), the SIMPLE-type sweeps, the two argument
errors and the JAX defaults."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.solvers import bgs as jbgs
from iemic_tpu.solvers import saddlepoint as jsp

from iemic_tpu_torch import interop
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.solvers import bgs as tbgs
from iemic_tpu_torch.solvers import factory as tfactory
from iemic_tpu_torch.solvers import saddlepoint as tsp

from test_torch_ocean import CASES, DATA, _close

# few inner iterations, so that the JAX side compiles quickly
FEW = {"Saddlepoint iterations": 4, "Auv iterations": 3}

# name -> (grid, BGS settings, limit on the relative max error of one
# sweep, the error measured).  The limits are those of
# tests/test_torch_ocean.py: 1e-8 on the island grid and 1e-4 on 2DMOC,
# where the coarsest multigrid level inverts a Tikhonov-shifted singular
# matrix by LU here and by Gauss-Jordan there.
VARIANTS = {
    "SL": ("island8x8x4", {"Saddlepoint scheme": "SL"}, 1e-8, 2.1e-13),
    "SR": ("island8x8x4", {"Saddlepoint scheme": "SR"}, 1e-8, 2.2e-13),
    "KRYLOV+Jacobi": ("island8x8x4", {"Saddlepoint scheme": "KRYLOV"},
                      1e-8, 3.5e-13),
    # the island's 64 columns make the 2D saddle's hierarchy one dense
    # shifted inverse, with which the saddle FGMRES is at round-off after
    # two iterations; from the fourth the two packages' iterates part
    # (measured 8.8e-13 with 2 iterations, 0.23 with 4)
    "KRYLOV+MG": ("island8x8x4", {"Saddlepoint scheme": "KRYLOV",
                                  "Saddlepoint Precond": "MG",
                                  "Saddlepoint iterations": 2}, 1e-8,
                  8.8e-13),
    "symmetric": ("island8x8x4", {"Scheme": "symmetric Gauss-Seidel"},
                  1e-8, 2.2e-13),
    "M2": ("island8x8x4", {"Permutation": 2}, 1e-8, 3.5e-13),
    "M3": ("island8x8x4", {"Permutation": 3}, 1e-8, 2.2e-13),
    "rhomu+Columns": ("island8x8x4", {"ATS rho/mu Transform": True,
                                      "ATS Precond": "Columns"}, 1e-8,
                      4.9e-13),
    "rhomu+MG": ("island8x8x4", {"ATS rho/mu Transform": True}, 1e-8,
                 4.1e-13),
    "rhomu+MG 2dmoc": ("2dmoc", {"ATS rho/mu Transform": True}, 1e-4,
                       1.3e-5),
    "rhomu+Columns 2dmoc": ("2dmoc", {"ATS rho/mu Transform": True,
                                      "ATS Precond": "Columns",
                                      "ATS iterations": 3}, 1e-4, 2.2e-13),
    "ATS Columns": ("island8x8x4", {"ATS Precond": "Columns"}, 1e-8,
                    1.0e-12),
    "ATS Columns, inner FGMRES": ("island8x8x4", {"ATS Precond": "Columns",
                                                  "ATS iterations": 3},
                                  1e-8, 3.0e-12),
    "Auv MG": ("island8x8x4", {"Saddlepoint scheme": "KRYLOV",
                               "Auv Precond": "MG"}, 1e-8, 3.5e-13),
    "prolong_w=0": ("island8x8x4", {"MG prolongation weight": 0.0}, 1e-8,
                    2.2e-13),
}


def _pair(case, prec, seed=0):
    """(jax ocean, torch ocean) with the BGS settings prec, at the same
    random state, Jacobians computed."""
    solver = {"Preconditioning": "BGS", "Precision": "Double",
              "Preconditioner": dict(FEW, **prec)}
    jo = JOcean(CASES[case](), solver_params=_copy(solver), data_dir=DATA)
    to = TOcean(CASES[case](), solver_params=_copy(solver), data_dir=DATA,
                device="cpu")
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.standard_normal(np.shape(jo.state))
    x[4] += np.linspace(1.0, -1.0, x.shape[1])[:, None, None]
    jo.set_state(jnp.asarray(x))
    interop.install_state(to, x)
    jo.compute_jacobian()
    to.compute_jacobian()
    return jo, to


def _copy(solver):
    return dict(solver, Preconditioner=dict(solver["Preconditioner"]))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_bgs_variant_sweep_matches_jax(name):
    case, prec, limit, _ = VARIANTS[name]
    jo, to = _pair(case, prec)
    fj, _ = jo._get_prec_factors()
    ft, _ = to._get_prec_factors()
    r = np.random.default_rng(3).standard_normal(np.shape(jo.state))
    zj = np.asarray(jo._prec_apply(fj, jnp.asarray(r)))
    zt = to._prec_apply(ft, torch.as_tensor(r)).numpy()
    assert np.isfinite(zt).all()
    _close(zt, zj, limit)


@pytest.mark.parametrize("scheme", ["SI", "SL", "SR"])
def test_apply_simple_schemes_match_jax(scheme):
    """One SIMPLE / SIMPLE(L) / SIMPLER sweep of the 2D saddle, with its
    inner Chat FGMRES, on the island grid: limit 1e-10, measured 1.6e-14
    (SI), 3.1e-15 (SL), 8.7e-15 (SR)."""
    jo, to = _pair("island8x8x4", {})
    fj, _ = jo._get_prec_factors()
    ft, _ = to._get_prec_factors()
    r = np.random.default_rng(5).standard_normal(
        (3,) + tuple(ft.spp_simple.chat.shape[1:]))
    zj = jsp.apply_simple(fj.spp_simple, jnp.asarray(r), periodic=False,
                          scheme=scheme)
    zt = tsp.apply_simple(ft.spp_simple, torch.as_tensor(r), periodic=False,
                          scheme=scheme)
    _close(zt.numpy(), zj, 1e-10)


def test_saddle_operator_matches_jax():
    """apply_saddle and apply_stencil_2d on the island grid's Spp and
    Chat: limit 1e-12, measured 1.8e-16 and 3.5e-16."""
    jo, to = _pair("island8x8x4", {})
    fj, _ = jo._get_prec_factors()
    ft, _ = to._get_prec_factors()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3,) + tuple(ft.Spp.shape[-2:]))
    _close(tsp.apply_saddle(ft.Spp, torch.as_tensor(x), False).numpy(),
           jsp.apply_saddle(fj.Spp, jnp.asarray(x), False), 1e-12)
    from iemic_tpu.solvers.mg import _OFFS25 as joffs
    from iemic_tpu_torch.solvers.mg import _OFFS25 as toffs
    p = rng.standard_normal(tuple(ft.Spp.shape[-2:]))
    _close(tsp.apply_stencil_2d(ft.spp_simple.chat, toffs,
                                torch.as_tensor(p), False).numpy(),
           jsp.apply_stencil_2d(fj.spp_simple.chat, joffs, jnp.asarray(p),
                                False), 1e-12)


def test_bgs_argument_errors():
    """An ordering other than 1, 2, 3, and the symmetric correction with
    another ordering than M1, raise as in the JAX package."""
    _, to = _pair("island8x8x4", {})
    ft, _ = to._get_prec_factors()
    r = torch.zeros_like(to.state)
    with pytest.raises(ValueError, match="invalid permutation 4"):
        tbgs.apply(ft, r, periodic=False, permutation=4, nit_spp=1)
    with pytest.raises(ValueError, match="requires permutation == 1"):
        tbgs.apply(ft, r, periodic=False, permutation=2, symmetric=True,
                   nit_spp=1, nit_uv=1)


def test_bgs_defaults_are_jax_defaults():
    """build and apply called with no optional argument give the JAX
    package's result (ATS Columns, 30 saddle iterations at 1e-6): limit
    1e-8, measured 1.2e-12."""
    jo, to = _pair("island8x8x4", {})
    fj = jbgs.build(jo.jac, np.asarray(jo.landm), periodic=False)
    ft = tbgs.build(to.jac, to.landm, periodic=False)
    assert ft.ts_mg is None and fj.ts_mg is None
    r = np.random.default_rng(7).standard_normal(np.shape(jo.state))
    zj = np.asarray(jbgs.apply(fj, jnp.asarray(r), periodic=False))
    zt = tbgs.apply(ft, torch.as_tensor(r), periodic=False).numpy()
    _close(zt, zj, 1e-8)


def test_factory_passes_rhomu_lambda():
    """"rho/mu lambda" reaches bgs.build: Q = [[-1, lam], [1/lam, 1]] /
    sqrt 2."""
    _, to = _pair("island8x8x4", {"ATS rho/mu Transform": True,
                                  "rho/mu lambda": 2.0})
    ft, _ = to._get_prec_factors()
    q = np.array([[-1.0, 2.0], [0.5, 1.0]]) / np.sqrt(2.0)
    np.testing.assert_allclose(ft.Qts.numpy(), q, rtol=1e-15)
    np.testing.assert_allclose((ft.Qts @ ft.Qts).numpy(), np.eye(2),
                               atol=1e-15)
    build, _ = tfactory.make_preconditioner(
        {"Method": "BGS", "ATS rho/mu Transform": True}, landm=to.landm,
        periodic=False, grid_shape=(4, 8, 8))
    lam = 7.6e-4 / 1.8e-4
    assert abs(float(build(to.jac).Qts[0, 1]) * np.sqrt(2.0) - lam) < 1e-14


@pytest.mark.parametrize("xline", [True, False])
def test_mg_options_match_jax(xline):
    """mg.build without the zonal line solve, and two smoother sweeps, on
    the island grid's T/S block with a hierarchy of three levels: one
    V-cycle and _smooth(nsweep=2) to 1e-10 (measured 9.0e-12 and 1.1e-12
    with the line solve, 8.4e-12 and 2.2e-12 without)."""
    from iemic_tpu.solvers import mg as jmg
    from iemic_tpu_torch.solvers import mg as tmg
    jo, to = _pair("island8x8x4", {})
    sub = to.jac[:, 4:6][:, :, 4:6]
    pj = jmg.build(jnp.asarray(sub.numpy()), periodic=False, min_cols=4,
                   xline=xline)
    pt = tmg.build(sub, periodic=False, min_cols=4, xline=xline)
    assert len(pt.levels) == len(pj.levels) == 3
    assert (pt.levels[0].xinv is None) == (not xline)
    r = np.random.default_rng(8).standard_normal(tuple(sub.shape[2:]))
    zj = jmg.apply(pj, jnp.asarray(r), periodic=False)
    zt = tmg.apply(pt, torch.as_tensor(r), periodic=False)
    _close(zt.numpy(), zj, 1e-10)
    sj = jmg._smooth(pj.levels[0], jnp.zeros_like(jnp.asarray(r)),
                     jnp.asarray(r), periodic=False, damping=0.9, nsweep=2)
    st = tmg._smooth(pt.levels[0], torch.zeros_like(torch.as_tensor(r)),
                     torch.as_tensor(r), periodic=False, damping=0.9,
                     nsweep=2)
    _close(st.numpy(), sj, 1e-10)
    one = tmg._smooth(pt.levels[0], torch.zeros_like(st), torch.as_tensor(r),
                      periodic=False, damping=0.9)
    assert not torch.equal(one, st)
