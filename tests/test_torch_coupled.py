"""Port parity of the coupled ocean-atmosphere-sea-ice model: the
atmosphere, the sea ice, the ocean's coupled branches, synchronize, the
six coupling blocks, the coupled matvec and block preconditioners, one
coupled solve, coupled Newton and the conservation integrals, against the
JAX package on the CPU in f64, from the same numpy inputs.

The coupled fixture is tests/test_coupled.py's (6x6x4, Columns + Double
ocean, coupled FGMRES 1e-10), so that the JAX compile cache of that file
serves here.  Comparisons are max-norm scaled: max|port - jax| / max|jax|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_coupled import BOUNDS, L, M, N
from test_coupled import make_coupled as make_jax_coupled
from test_coupled import _random_state as jax_random_state
from iemic_tpu.models.atmosphere import Atmosphere as JAtmosphere
from iemic_tpu.models.seaice import SeaIce as JSeaIce
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch import interop
from iemic_tpu_torch.models.atmosphere import Atmosphere as TAtmosphere
from iemic_tpu_torch.models.coupled import CoupledModel as TCoupled
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.models.seaice import SeaIce as TSeaIce
from iemic_tpu_torch.utils import logging as tlog


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch and the BLAS and OpenMP pools on one thread in this module,
    as tests/test_torch_topo.py does: small problems, shared cores."""
    from threadpoolctl import threadpool_limits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _quiet():
    jlog.set_verbose(False)
    tlog.set_verbose(False)
    yield
    jlog.set_verbose(True)
    tlog.set_verbose(True)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"relative max error {err:.3e} > {rtol:.1e}"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def make_port_coupled(use_seaice=True, comb=0.3, prec="F"):
    """The port's counterpart of test_coupled.make_coupled."""
    ocean = TOcean({"THCM": {
        "Global Grid-Size n": N, "Global Grid-Size m": M,
        "Global Grid-Size l": L, **BOUNDS,
        "Coupled Temperature": 1, "Coupled Salinity": 1,
        "Restoring Salinity Profile": 0,
        "Starting Parameters": {"Combined Forcing": comb,
                                "Salinity Forcing": 0.1,
                                "Solar Forcing": 0.5,
                                "Wind Forcing": 1.0,
                                "Temperature Forcing": 1.0},
    }}, solver_params={"Preconditioning": "Columns", "Precision": "Double",
                       "FGMRES tolerance": 1e-8}, device="cpu")
    atmos = TAtmosphere({"Global Grid-Size n": N, "Global Grid-Size m": M,
                         **BOUNDS, "Combined Forcing": comb}, device="cpu")
    seaice = TSeaIce({"Global Grid-Size n": N, "Global Grid-Size m": M,
                      **BOUNDS, "Combined Forcing": comb}, device="cpu") \
        if use_seaice else None
    return TCoupled(ocean, atmos, seaice,
                    params={"Use sea ice": use_seaice,
                            "Preconditioning": prec},
                    solver_params={"FGMRES tolerance": 1e-10,
                                   "FGMRES iterations": 300})


def _pair(comb=0.3, prec="F", seed=1, use_seaice=True):
    """(jax coupled, port coupled) at the same random state, Jacobians
    computed (which synchronizes both)."""
    jc = make_jax_coupled(use_seaice=use_seaice, comb=comb)
    jc.prec_scheme = prec
    tc = make_port_coupled(use_seaice=use_seaice, comb=comb, prec=prec)
    x = np.asarray(jax_random_state(jc, seed=seed))
    jc.set_state(jnp.asarray(x))
    interop.install_flat_state(tc, x)
    jc.compute_jacobian()
    tc.compute_jacobian()
    return jc, tc


# ---------------------------------------------------------------------
# atmosphere and sea ice alone
# ---------------------------------------------------------------------

def _atmos_pair(periodic, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(8, 8)) < 0.3).astype(np.int32)
    pars = {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
            "Periodic": periodic, "Combined Forcing": 0.7}
    ja = JAtmosphere(dict(pars), surfmask=mask)
    ta = TAtmosphere(dict(pars), surfmask=mask, device="cpu")
    x = 0.1 * rng.standard_normal(ja.dim)
    sst, sit = rng.standard_normal((2, 8, 8))
    msi = (rng.uniform(size=(8, 8)) < 0.2).astype(np.float64)
    for a, conv in ((ja, jnp.asarray),
                    (ta, lambda v: interop.tensor(v, "cpu"))):
        a.set_ocean_temperature(conv(sst))
        a.set_seaice_temperature(conv(sit))
        a.set_seaice_mask(conv(msi))
        a.set_ocean_deps(1.3, 0.8)
    ja.set_state(jnp.asarray(x))
    interop.install_flat_state(ta, x)
    for a in (ja, ta):
        a.compute_rhs()
        a.compute_jacobian()
        a.compute_mass_matrix()
    return ja, ta, rng


@pytest.mark.parametrize("periodic", [False, True])
def test_atmosphere_matches_jax(periodic):
    """F, the Jacobian's stencil, P column and P row, the matvec, the mass
    diagonal, evaporation and precipitation to 1e-12; the dense solve to
    1e-10 (measured below 1e-14 and 1e-13)."""
    ja, ta, rng = _atmos_pair(periodic, seed=3 + periodic)
    _close(_np(ta.rhs), ja.rhs, 1e-12)
    for k in ("stencil", "col_P", "prow_q", "prow_P"):
        _close(_np(getattr(ta.jac, k)), getattr(ja.jac, k), 1e-12)
    v = rng.standard_normal(ja.dim)
    _close(_np(ta.apply_matrix(interop.tensor(v, "cpu"))),
           ja.apply_matrix(jnp.asarray(v)), 1e-12)
    _close(_np(ta.diagB), ja.diagB, 1e-12)
    _close(_np(ta.get_evaporation()), ja.get_evaporation(), 1e-12)
    _close(_np(ta.get_precipitation()), ja.get_precipitation(), 1e-12)
    _close(_np(ta.solve(interop.tensor(v, "cpu"))), ja.solve(jnp.asarray(v)),
           1e-10)
    # the factors follow the Jacobian: a mass shift refactors
    for a in (ja, ta):
        a.add_mass_to_jacobian(-3.0)
    _close(_np(ta.solve(interop.tensor(v, "cpu"))), ja.solve(jnp.asarray(v)),
           1e-10)


def test_seaice_matches_jax():
    """F, the 4x4 blocks D, the gamma row and the exact solve to 1e-12
    at a random state with random interface fields."""
    rng = np.random.default_rng(7)
    pars = {"Global Grid-Size n": 8, "Global Grid-Size m": 6,
            "Combined Forcing": 0.6, "Latent Heat Forcing": 0.8}
    js, ts = JSeaIce(dict(pars)), TSeaIce(dict(pars), device="cpu")
    x = 0.05 * rng.standard_normal(js.dim)
    f = rng.standard_normal((6, 6, 8))
    js.set_ocean_fields(jnp.asarray(f[0]), jnp.asarray(f[1]))
    ts.set_ocean_fields(interop.tensor(f[0], "cpu"),
                        interop.tensor(f[1], "cpu"))
    js.set_atmosphere_fields(*(jnp.asarray(v) for v in f[2:]))
    ts.set_atmosphere_fields(*(interop.tensor(v, "cpu") for v in f[2:]))
    js.pQSnd = ts.pQSnd = 0.37
    js.set_state(jnp.asarray(x))
    interop.install_flat_state(ts, x)
    for s in (js, ts):
        s.compute_rhs()
        s.compute_jacobian()
    _close(_np(ts.rhs), js.rhs, 1e-12)
    for got, ref in zip(ts.jac, js.jac):
        _close(_np(got), ref, 1e-12)
    b = rng.standard_normal(js.dim)
    _close(_np(ts.solve(interop.tensor(b, "cpu"))), js.solve(jnp.asarray(b)),
           1e-12)
    _close(_np(ts.apply_matrix(interop.tensor(b, "cpu"))),
           js.apply_matrix(jnp.asarray(b)), 1e-12)


# ---------------------------------------------------------------------
# the coupled model
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def coupled_pair():
    return _pair()


def test_synchronize_matches_jax(coupled_pair):
    """Every field and coefficient synchronize pushes, to 1e-14."""
    jc, tc = coupled_pair
    for name in ("tatm", "qatm", "albe", "patm", "suno", "qsa", "msi",
                 "gsi"):
        _close(_np(getattr(tc.ocean.fields, name)),
               getattr(jc.ocean.fields, name), 1e-14)
    for name, ref in jc.ocean.cpl._asdict().items():
        _close(getattr(tc.ocean.cpl, name), ref, 1e-14)
    ja, ta, js, ts = jc.atmos, tc.atmos, jc.seaice, tc.seaice
    for name in ("sst", "sit", "msi"):
        _close(_np(getattr(ta, name)), getattr(ja, name), 1e-14)
    for name in ("Ooa", "Os"):
        _close(getattr(ta, name), getattr(ja, name), 1e-14)
    for name in ("sst", "sss", "tatm", "qatm", "patm", "albe"):
        _close(_np(getattr(ts, name)), getattr(js, name), 1e-14)
    for name in ("pQSnd", "albe0", "albed"):
        _close(getattr(ts, name), getattr(js, name), 1e-14)
    assert np.abs(_np(tc.ocean.fields.msi)).max() > 1e-3   # msi != 0


def test_coupled_ocean_matches_jax(coupled_pair):
    """The ocean's coupled residual and stencil tensor with msi != 0, its
    coupled flux components and salinity correction, to 1e-12."""
    jc, tc = coupled_pair
    jc.compute_rhs()
    tc.compute_rhs()
    _close(_np(tc.ocean.rhs), jc.ocean.rhs, 1e-12)
    _close(_np(tc.ocean.jac), jc.ocean.jac, 1e-12)
    jf, tf = jc.ocean.surface_fluxes(), tc.ocean.surface_fluxes()
    assert sorted(tf) == sorted(jf) and len(tf) == 8
    for k in jf:
        _close(tf[k], jf[k], 1e-12)
    _close(tc.ocean.get_s_corr(), jc.ocean.get_s_corr(), 1e-12)
    _close(_np(tc.get_rhs()), jc.get_rhs(), 1e-12)


@pytest.mark.parametrize("i,j", [(0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
                                 (2, 1)])
def test_coupling_block_matches_jax(coupled_pair, i, j):
    """C_ij v_j to 1e-11 of jax.jvp, and nonzero: both the block the port
    assembles from its probes and the port's forward-mode derivative
    through the cross map, which the block must equal (1e-13)."""
    jc, tc = coupled_pair
    v = np.random.default_rng(10 * i + j).standard_normal(jc._shapes[j])
    ref = np.asarray(jc.coupling_apply(i, j, jnp.asarray(v)))
    got = _np(tc.coupling_apply(i, j, interop.tensor(v, "cpu")))
    jvp = _np(tc.coupling_jvp(i, j, interop.tensor(v, "cpu")))
    assert np.abs(ref).max() > 1e-10
    _close(got, ref, 1e-11)
    _close(jvp, ref, 1e-11)
    _close(got, jvp, 1e-13)


@pytest.mark.parametrize("prec", ["D", "B", "F"])
def test_apply_matrix_and_precon_match_jax(prec):
    """The coupled matvec and the block preconditioner sweep under D, B
    and F to 1e-11."""
    jc, tc = _pair(prec=prec, seed=4)
    v = np.asarray(jax_random_state(jc, seed=5, scale=1.0))
    tv = interop.tensor(v, "cpu")
    _close(_np(tc.apply_matrix(tv)), jc.apply_matrix(jnp.asarray(v)), 1e-11)
    _close(_np(tc.apply_precon(tv)), jc.apply_precon(jnp.asarray(v)), 1e-11)


def _at_rest(comb, tol=1e-7):
    jc = make_jax_coupled(use_seaice=True, comb=comb)
    tc = make_port_coupled(use_seaice=True, comb=comb)
    for c in (jc, tc):
        c.fgmres_tol = tol
        c.fgmres_iters = 350
    jc.set_state(jc.get_state() * 0.0)
    tc.set_state(tc.get_state() * 0.0)
    return jc, tc


def test_coupled_solve_matches_jax():
    """test_coupled_solve in both packages: J x = b at the COMB = 0 rest
    state with a consistent b; both reach 1e-7, iterations within 2."""
    jc, tc = _at_rest(0.0)
    jc.compute_jacobian()
    tc.compute_jacobian()
    w = np.asarray(jax_random_state(jc, seed=6, scale=1.0))
    b = np.asarray(jc.apply_matrix(jnp.asarray(w)))
    jsol = jc.solve(jnp.asarray(b))
    tsol = tc.solve(interop.tensor(b, "cpu"))
    jrel = float(jnp.linalg.norm(jc.apply_matrix(jsol) - b)
                 / np.linalg.norm(b))
    trel = float(torch.linalg.norm(tc.apply_matrix(tsol)
                                   - interop.tensor(b, "cpu"))
                 / np.linalg.norm(b))
    assert jrel < 1e-5 and trel < 1e-5, (jrel, trel)
    assert tc.solve_relres <= 1e-7 and tc.solve_tol == 1e-7
    assert abs(tc.solve_iters - jc.solve_iters) <= 2, \
        (tc.solve_iters, jc.solve_iters)


def _newton(c, norm, tol, iters=15):
    seq = []
    for _ in range(iters):
        c.compute_rhs()
        seq.append(norm(c.get_rhs()))
        if seq[-1] < tol:
            break
        c.compute_jacobian()
        c.set_state(c.get_state() + c.solve(-c.get_rhs()))
    return seq


def test_coupled_newton_and_integrals_match_jax():
    """test_coupled_newton and test_coupled_EP_and_seaice_correction in
    the port: Newton from rest at COMB = 0 reaches |F| < 1e-7 in as many
    iterations as the JAX package, with its |F| sequence to 1e-8 relative
    per iteration while |F| > 1e-6 (measured 8.7e-9 at most), and at the
    equilibrium the E - P budget closes over the ocean area and the
    ocean's salinity correction equals the sea-ice gamma.  The solves ask
    the fixture's 1e-10: the system is near singular here
    (test_coupled.py:168-190), and at 1e-7 the two packages' iterates
    part by 2.6% after eight iterations."""
    jc, tc = _at_rest(0.0, tol=1e-10)
    jseq = _newton(jc, lambda v: float(jnp.linalg.norm(v)), 1e-10)
    tseq = _newton(tc, lambda v: float(torch.linalg.norm(v)), 1e-10)
    assert tseq[-1] < 1e-7 and len(tseq) == len(jseq), (tseq, jseq)
    big = np.asarray(jseq) > 1e-6
    np.testing.assert_allclose(np.asarray(tseq)[big], np.asarray(jseq)[big],
                               rtol=1e-8)

    atmos, ocean, seaice = tc.atmos, tc.ocean, tc.seaice
    E, P = _np(atmos.get_evaporation()), _np(atmos.get_precipitation())
    I = float(np.sum((E - P) * atmos.p_coeff))
    scale = max(float(np.sum(np.abs(E) * atmos.p_coeff)), 1e-30)
    assert abs(I) < 1e-7 * max(scale, 1.0), (I, scale)
    scorr, gamma = ocean.get_s_corr(), float(seaice.get_gamma())
    assert abs(scorr - gamma) < 1e-8 + 1e-6 * abs(gamma), (scorr, gamma)
    _close(scorr, jc.ocean.get_s_corr(), 1e-8)


def test_coupled_models_default_to_the_card():
    """Atmosphere and SeaIce run on the card unless asked for the CPU,
    and raise where there is none."""
    import inspect
    for cls in (TAtmosphere, TSeaIce):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls({})
