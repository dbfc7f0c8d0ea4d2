"""Port parity: the ocean residual, Jacobian, row scaling, deflator and
one BGS sweep against the JAX package, on CPU, from the same random
state (2DMOC 3x6x6 and the masked 8x8x4 island grid, mixing on)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from iemic_tpu.models.ocean import Ocean as JOcean

from iemic_tpu_torch import interop
from iemic_tpu_torch.models.ocean import Ocean as TOcean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")

SOLVER = {"Preconditioning": "BGS", "Precision": "Mixed",
          "FGMRES tolerance": 1e-3, "FGMRES iterations": 200}


def _2dmoc_params():
    """test/2dmoc/ocean_params.xml (tests/test_continuation_2dmoc.py),
    with nonzero forcing so every term of F is active."""
    return {"THCM": {
        "Global Grid-Size n": 3, "Global Grid-Size m": 6,
        "Global Grid-Size l": 6,
        "Global Bound xmin": 286.0, "Global Bound xmax": 350.0,
        "Global Bound ymin": -60.0, "Global Bound ymax": 60.0,
        "Periodic": True, "Depth hdim": 4000.0, "Topography": 1,
        "Flat Bottom": True, "Coriolis Force": 0, "Forcing Type": 1,
        "Restoring Temperature Profile": 1,
        "Restoring Salinity Profile": 0,
        "Wind Forcing Type": 2, "Mixing": 1, "Rho Mixing": False,
        "Starting Parameters": {
            "Combined Forcing": 0.5, "Salinity Forcing": 0.1,
            "Temperature Forcing": 10.0, "Wind Forcing": 0.0,
            "Rossby-Number": 0.0, "Horizontal Ekman-Number": 371.764,
            "Rayleigh-Number": 15.6869, "P_VC": 0.0}}}


def _island_params():
    """The masked 8x8x4 grid of tests/test_masks.py."""
    return {"THCM": {
        "Global Grid-Size n": 8, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Read Land Mask": True,
        "Land Mask": "test8x8x4_3",
        "Starting Parameters": {"Combined Forcing": 0.5,
                                "Temperature Forcing": 10.0,
                                "Salinity Forcing": 0.1,
                                "Wind Forcing": 1.0}}}


def _global32_params():
    """run/ocean/global's THCM list (periodic, real land mask, restoring
    T and S, wind) at 32x16x8 with the repository's mask of that size."""
    return {"THCM": {
        "Global Grid-Size n": 32, "Global Grid-Size m": 16,
        "Global Grid-Size l": 8, "Global Bound xmin": 0.0,
        "Global Bound xmax": 360.0, "Global Bound ymin": -85.5,
        "Global Bound ymax": 85.5, "Periodic": True,
        "Read Land Mask": True, "Land Mask": "mask_global_32x16x8",
        "Flat Bottom": False, "Coriolis Force": 1, "Forcing Type": 0,
        "Wind Forcing Type": 2, "Restoring Temperature Profile": 1,
        "Restoring Salinity Profile": 1,
        "Starting Parameters": {"Combined Forcing": 0.5,
                                "Temperature Forcing": 10.0,
                                "Salinity Forcing": 0.1,
                                "Wind Forcing": 1.0}}}


CASES = {"2dmoc": _2dmoc_params, "island8x8x4": _island_params,
         "global32x16x8": _global32_params}
# one BGS sweep compiles the whole preconditioner on the JAX side:
# kept to the small grids
BGS_CASES = ["2dmoc", "island8x8x4"]


def _pair(case, seed=0):
    """(jax ocean, torch ocean) at the same random state."""
    params = CASES[case]()
    jo = JOcean(params, solver_params=dict(SOLVER), data_dir=DATA)
    to = TOcean(CASES[case](), solver_params=dict(SOLVER), data_dir=DATA,
                device="cpu")
    assert np.array_equal(np.asarray(jo.landm), to.landm)
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.standard_normal(np.shape(jo.state))
    x[4] += np.linspace(1.0, -1.0, x.shape[1])[:, None, None]  # stratified T
    jo.set_state(jnp.asarray(x))
    interop.install_state(to, x)
    np.testing.assert_array_equal(np.asarray(jo.par), to.par.numpy())
    return jo, to


def _close(got, ref, rtol):
    """Max-norm-scaled comparison."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max() / scale
    print(f"relative max error {err:.3e} (limit {rtol:.1e})")
    assert err <= rtol, f"relative max error {err:.3e} > {rtol:.1e}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_rhs_and_jacobian_match_jax(case):
    jo, to = _pair(case)
    jo.compute_rhs()
    to.compute_rhs()
    _close(to.rhs.numpy(), jo.rhs, 1e-12)
    jo.compute_jacobian()
    to.compute_jacobian()
    _close(to.jac.numpy(), jo.jac, 1e-12)
    # the Jacobian action, integral-condition row included
    v = np.random.default_rng(1).standard_normal(np.shape(jo.state))
    _close(to.apply_matrix(torch.as_tensor(v)).numpy(),
           jo.apply_matrix(jnp.asarray(v)), 1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rowscale_and_deflator_match_jax(case):
    jo, to = _pair(case)
    jo.compute_jacobian()
    to.compute_jacobian()
    jo._get_prec_factors()
    to._get_prec_factors()
    _close(to._rowscale.numpy(), jo._rowscale, 1e-12)
    assert abs(to._rint - float(jo._rint)) <= 1e-12 * abs(float(jo._rint))
    qj, qt = jo._get_deflator(), to._get_deflator()
    assert (qj is None) == (qt is None)
    if qj is not None:
        # compare the projectors Q Q^T v (a QR basis is fixed up to sign)
        v = np.random.default_rng(2).standard_normal(qt.shape[0])
        pj = np.asarray(qj) @ (np.asarray(qj).T @ v)
        pt = (qt @ (qt.T @ torch.as_tensor(v))).numpy()
        _close(pt, pj, 1e-12)


# (f64, f32) tolerances of one BGS sweep.  The sweep runs an inner
# saddle FGMRES (60 iterations at tol 1e-8 in the bundles) and an ATS
# multigrid V-cycle whose coarsest level inverts a Tikhonov-shifted
# (1e-12) dense matrix: LU (torch) against Gauss-Jordan (JAX) differs
# there by ~eps * cond.  Measured f64 agreement at the bundle settings:
# 2e-10 on the island grid, 4e-6 on 2DMOC, whose non-restoring ATS block
# makes that coarse matrix singular (cond 5e17).  In f32 the 60-iteration
# saddle solve runs past the f32 noise floor and amplifies round-off
# (measured 6e-2 on the island grid, growing from 3e-6 at 20
# iterations), so the f32 sweep is compared with 5 inner iterations:
# measured 7e-7 (island) and 4e-6 (2DMOC).
BGS_TOL = {"island8x8x4": (1e-8, 1e-5), "2dmoc": (1e-4, 1e-4)}


@pytest.mark.parametrize("case", BGS_CASES)
def test_bgs_apply_matches_jax(case):
    """One BGS sweep on the same residual, f64 and f32 factors."""
    from iemic_tpu.solvers import bgs as jbgs
    from iemic_tpu_torch.solvers import bgs as tbgs
    tol64, tol32 = BGS_TOL[case]
    jo, to = _pair(case)
    jo.compute_jacobian()
    to.compute_jacobian()
    fj, fj32 = jo._get_prec_factors()
    ft, ft32 = to._get_prec_factors()
    r = np.random.default_rng(3).standard_normal(np.shape(jo.state))
    zj = np.asarray(jo._prec_apply(fj, jnp.asarray(r)))
    zt = to._prec_apply(ft, torch.as_tensor(r)).numpy()
    _close(zt, zj, tol64)
    per = jo.cfg.periodic
    zj32 = np.asarray(jbgs.apply(fj32, jnp.asarray(r, jnp.float32),
                                 periodic=per, nit_spp=5))
    zt32 = tbgs.apply(ft32, torch.as_tensor(r, dtype=torch.float32),
                      periodic=per, nit_spp=5)
    assert zt32.dtype == torch.float32
    _close(zt32.numpy(), zj32, tol32)


@pytest.mark.parametrize("seed", [3, 7])
def test_f32_sweep_gap_is_jax_own(seed):
    """At the bundles' 60 inner saddle iterations the f32 sweep runs
    past the f32 noise floor, in the JAX package as in the port: JAX's
    own f32 sweep is then far from its f64 sweep (measured 8.4e-2 and
    2.0e-2 on the island grid for seeds 3 and 7), and the port's f32
    sweep lies no further from the f64 sweep than that (measured 1.2e-1
    and 1.6e-2; limit three times JAX's own gap)."""
    from iemic_tpu.solvers import bgs as jbgs
    from iemic_tpu_torch.solvers import bgs as tbgs
    jo, to = _pair("island8x8x4")
    jo.compute_jacobian()
    to.compute_jacobian()
    fj, fj32 = jo._get_prec_factors()
    _, ft32 = to._get_prec_factors()
    r = np.random.default_rng(seed).standard_normal(np.shape(jo.state))
    per = jo.cfg.periodic
    z64 = np.asarray(jbgs.apply(fj, jnp.asarray(r), periodic=per,
                                nit_spp=60))
    zj32 = np.asarray(jbgs.apply(fj32, jnp.asarray(r, jnp.float32),
                                 periodic=per, nit_spp=60), np.float64)
    zt32 = tbgs.apply(ft32, torch.as_tensor(r, dtype=torch.float32),
                      periodic=per, nit_spp=60).double().numpy()

    def gap(z):
        return np.abs(z - z64).max() / np.abs(z64).max()
    print(f"f32 sweep against f64: JAX {gap(zj32):.3e}, port "
          f"{gap(zt32):.3e}")
    assert gap(zj32) >= 1e-2
    assert gap(zt32) <= 3 * gap(zj32)


@pytest.mark.parametrize("case", BGS_CASES)
def test_simple_sweep_matches_jax(case):
    """One SIMPLE sweep (apply_simple, scheme SI, with its inner Chat
    FGMRES) from the SIMPLE factors of the same Jacobian, f64."""
    from iemic_tpu.solvers import saddlepoint as jsp
    from iemic_tpu_torch.solvers import saddlepoint as tsp
    jo, to = _pair(case)
    jo.compute_jacobian()
    to.compute_jacobian()
    fj, _ = jo._get_prec_factors()
    ft, _ = to._get_prec_factors()
    _close(ft.spp_simple.chat.numpy(), fj.spp_simple.chat, 1e-12)
    r = np.random.default_rng(5).standard_normal(
        (3,) + tuple(ft.spp_simple.chat.shape[1:]))
    per = jo.cfg.periodic
    zj = jsp.apply_simple(fj.spp_simple, jnp.asarray(r), periodic=per)
    zt = tsp.apply_simple(ft.spp_simple, torch.as_tensor(r), periodic=per)
    # a 12-iteration Chat FGMRES over a V-cycle whose coarsest level is
    # a shifted dense inverse (LU against Gauss-Jordan, see BGS_TOL)
    _close(zt.numpy(), zj, BGS_TOL[case][0])


def test_interop_carries_jax_inputs():
    """par, land mask, forcing fields, state and An installed from the
    JAX package give the port the same residual and Jacobian action."""
    def params():
        p = _island_params()
        p["THCM"]["Wind Forcing Type"] = 1       # wind from the fields
        return p

    jo = JOcean(params(), solver_params=dict(SOLVER), data_dir=DATA)
    to = TOcean(params(), solver_params=dict(SOLVER), data_dir=DATA,
                device="cpu")
    assert to.fields.taux is None                # no wind data file here
    rng = np.random.default_rng(4)
    _, l, m, n = np.shape(jo.state)
    taux, tauy = rng.standard_normal((2, m, n))
    jo.fields = jo.fields._replace(taux=jnp.asarray(taux),
                                   tauy=jnp.asarray(tauy))
    interop.install_forcing(to, taux=taux, tauy=tauy)
    jo.set_par("Combined Forcing", 0.3)
    interop.install_par(to, np.asarray(jo.par))
    interop.install_land_mask(to, np.asarray(jo.landm))
    x = 0.05 * rng.standard_normal((6, l, m, n))
    jo.set_state(jnp.asarray(x))
    interop.install_state(to, np.asarray(jo.to_flat()))   # flat order
    np.testing.assert_array_equal(to.state.numpy(), x)
    jo.compute_rhs()
    to.compute_rhs()
    _close(to.rhs.numpy(), jo.rhs, 1e-12)
    jo.compute_jacobian()
    to.jac = interop.stencil(np.asarray(jo.jac), "cpu")
    v = rng.standard_normal((6, l, m, n))
    _close(to.apply_matrix(torch.as_tensor(v)).numpy(),
           jo.apply_matrix(jnp.asarray(v)), 1e-12)
