"""Port parity of the ocean tooling against the JAX package, on the CPU
in f64: the flux probes and the state file's flux extras, the legacy
fort.3 output, the seasonal forcing cycle, the barotropic streamfunction
and maximum velocities, the state hash and the numerical Jacobian."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.models.ocean import diagnostics as jdiag
from iemic_tpu.ops.stencil import from_flat as jfrom_flat
from iemic_tpu.ops.stencil import to_flat as jto_flat
from iemic_tpu.utils import hashing as jhash
from iemic_tpu.utils.numjac import NumericalJacobian as JNumericalJacobian

from iemic_tpu_torch import interop
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.models.ocean import diagnostics as tdiag
from iemic_tpu_torch.ops.stencil import from_flat, to_flat
from iemic_tpu_torch.utils import hashing as thash
from iemic_tpu_torch.utils.numjac import NumericalJacobian

# the basin of tests/test_checkpoint.py, salinity with an integral
# condition, every forcing term on
THCM = {"Global Grid-Size n": 4, "Global Grid-Size m": 4,
        "Global Grid-Size l": 3, "Restoring Salinity Profile": 0,
        "Starting Parameters": {"Combined Forcing": 0.3,
                                "Temperature Forcing": 10.0,
                                "Salinity Forcing": 1.0,
                                "Wind Forcing": 1.0}}


def _pair(thcm=THCM, **ocean):
    """The same ocean in both packages at the same random state."""
    params = dict(ocean, THCM=thcm)
    jo = JOcean(dict(params))
    to = TOcean(dict(params), device="cpu")
    x = 0.1 * np.random.default_rng(7).standard_normal(tuple(jo.state.shape))
    jo.set_state(jnp.asarray(x))
    interop.install_state(to, x)
    return jo, to


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def test_surface_fluxes_and_s_corr_match_jax():
    jo, to = _pair()
    jf, tf = jo.surface_fluxes(), to.surface_fluxes()
    assert sorted(tf) == sorted(jf) == ["SalinityFlux", "TemperatureFlux"]
    for k in jf:
        _close(tf[k], jf[k], 1e-13)
        assert np.abs(jf[k]).max() > 0
    # the salinity integral condition takes the flux's mean out: the
    # correction is round-off, held to the flux's own scale
    assert abs(to.get_s_corr() - jo.get_s_corr()) \
        <= 1e-13 * np.abs(jf["SalinityFlux"]).max()


@pytest.mark.parametrize("sal,tem", [(True, False), (False, True),
                                     (True, True)])
def test_state_file_flux_extras_match_jax(tmp_path, sal, tem):
    """save_state_to_file with "Save salinity flux" / "Save temperature
    flux": the same datasets in the two files, equal to 1e-13."""
    h5py = pytest.importorskip("h5py")
    jo, to = _pair(**{"Save salinity flux": sal,
                      "Save temperature flux": tem})
    files = [str(tmp_path / n) for n in ("jax.h5", "port.h5")]
    jo.save_state_to_file(files[0])
    to.save_state_to_file(files[1])

    def datasets(path):
        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda name, d: out.__setitem__(name, d[()])
                         if isinstance(d, h5py.Dataset) else None)
        return out

    jd, td = datasets(files[0]), datasets(files[1])
    assert sorted(td) == sorted(jd)
    assert ("SalinityFlux/Values" in td) == sal
    assert ("TemperatureFlux/Values" in td) == tem
    for k in jd:
        if np.asarray(jd[k]).dtype.kind == "f":
            _close(td[k], jd[k], 1e-13)
        else:
            assert np.array_equal(td[k], jd[k]), k


def test_write_fort3_matches_jax(tmp_path):
    """The legacy fort.3 text files are equal, and post_process writes it
    where "Use legacy fort.3 output" is set."""
    jo, to = _pair(**{"Use legacy fort.3 output": True})
    jo.write_fort3(str(tmp_path / "jax.3"))
    to.write_fort3(str(tmp_path / "port.3"))
    assert (tmp_path / "port.3").read_text() \
        == (tmp_path / "jax.3").read_text()
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        to.post_process()
    finally:
        os.chdir(cwd)
    assert (tmp_path / "fort.3").read_text() \
        == (tmp_path / "port.3").read_text()


def test_seasonal_forcing_matches_jax():
    """Time Dependent Forcing with random monthly wind, temperature and
    salinity fields: the fields and F at three times of the year equal to
    1e-13, and set_par("Time") no longer an unknown parameter; a negative
    time resets to the annual means."""
    from iemic_tpu_torch.models.ocean.forcing_data import (R0DIM,
                                                           SECS_PER_YEAR, UDIM)
    thcm = dict(THCM, **{"Levitus T": 0, "Levitus S": 0,
                         "Wind Forcing Type": 1,
                         "Time Dependent Forcing": True})
    jo, to = _pair(thcm)
    rng = np.random.default_rng(8)
    monthly = {k: rng.standard_normal((12, 4, 4))
               for k in ("mtaux", "mtauy", "mtatm", "memip")}
    for k, v in monthly.items():
        setattr(jo.monthly_forcing, k, v)
    interop.install_monthly_forcing(to, **monthly)
    year = SECS_PER_YEAR / (R0DIM / UDIM)
    for t in (0.1 * year, 0.45 * year, 1.8 * year, -1.0):
        jo.set_par("Time", t)
        to.set_par("Time", t)
        for k in ("taux", "tauy", "tatm", "emip"):
            _close(getattr(to.fields, k).numpy(),
                   np.asarray(getattr(jo.fields, k)), 1e-13)
        jo.compute_rhs()
        to.compute_rhs()
        _close(to.rhs.numpy(), np.asarray(jo.rhs), 1e-13)
    assert to._time == -1.0
    assert not to.fields.emip.any()


def test_psi_b_and_max_velocities_match_jax():
    for thcm in (THCM, dict(THCM, Periodic=True)):
        jo, to = _pair(thcm)
        _close(tdiag.psi_b(to.state, to.grid, to.landm).numpy(),
               jdiag.psi_b(jo.state, jo.grid, jo.landm), 1e-13)
        tv = tdiag.max_velocities(to.state, to.grid, to.landm)
        jv = jdiag.max_velocities(jo.state, jo.grid, jo.landm)
        np.testing.assert_allclose(tv, jv, rtol=1e-13)


def test_state_hash_matches_jax():
    """The same bits hash the same in both packages, from a tensor or an
    array; one bit flipped changes the hash."""
    jo, to = _pair()
    h = jhash.state_hash(jo.state)
    assert thash.state_hash(to.state) == h == thash.state_hash(
        to.state.numpy())
    assert thash.model_hash(to) == jhash.model_hash(jo) == h
    y = to.state.clone()
    y.view(-1).view(torch.int64)[5] ^= 1
    assert thash.state_hash(y) != h


def test_numerical_jacobian_matches():
    """The finite-difference Jacobian of the port's residual against the
    port's own Jacobian action (the testEntries pattern) and against the
    JAX package's finite-difference matrix, to 1e-8."""
    thcm = dict(THCM, **{"Global Grid-Size n": 3, "Global Grid-Size m": 3,
                         "Global Grid-Size l": 2})
    jo, to = _pair(thcm)
    l, m, n = to.cfg.l, to.cfg.m, to.cfg.n
    x = to_flat(to.state)
    nj = NumericalJacobian(lambda v: to_flat(to._rhs(from_flat(v, l, m, n),
                                                     to.par)), x)
    to.compute_jacobian()
    worst = nj.test_entries(
        lambda v: to_flat(to.apply_matrix(from_flat(v, l, m, n))), tol=1e-8)
    assert worst < 1e-8
    jfn = jo._rhs_fn
    jnj = JNumericalJacobian(
        lambda v: jto_flat(jfn(jfrom_flat(v, l, m, n), jo.par, jo.fields,
                               jo.cpl, jo.int_correction)),
        jto_flat(jo.state))
    assert nj.shape == jnj.shape == (6 * l * m * n,) * 2
    _close(nj.mat, jnj.mat, 1e-8)
    beg, jco, co = nj.ccs(drop_tol=1e-12)
    assert beg[-1] == len(jco) == len(co) > 0
