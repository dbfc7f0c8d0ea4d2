"""Port parity of the post-processing toolbox (tests/test_post.py's cases
in both packages): transports through sections and paths, the readers of
states, eigenvector files, cdata/tdata tables and profiles, and the plots
of the ocean, atmosphere and sea ice, from the same numpy inputs.  The
plots are compared by the arrays they draw."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu import post as jpost
from iemic_tpu.models.atmosphere import Atmosphere as JAtmosphere
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.models.seaice import SeaIce as JSeaIce
from iemic_tpu.post import transports as jtransports
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch import interop
from iemic_tpu_torch import post as tpost
from iemic_tpu_torch.models.atmosphere import Atmosphere as TAtmosphere
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.models.seaice import SeaIce as TSeaIce
from iemic_tpu_torch.post import transports as ttransports
from iemic_tpu_torch.utils import hdf5 as th5
from iemic_tpu_torch.utils import logging as tlog


@pytest.fixture(autouse=True)
def _quiet():
    jlog.set_verbose(False)
    tlog.set_verbose(False)
    yield
    jlog.set_verbose(True)
    tlog.set_verbose(True)


@pytest.fixture(scope="module")
def oceans():
    """The 6x6x4 box of test_path_transport_consistency at the same
    random state in both packages."""
    params = {"THCM": {"Global Grid-Size n": 6, "Global Grid-Size m": 6,
                       "Global Grid-Size l": 4,
                       "Starting Parameters": {"Combined Forcing": 0.1,
                                               "Temperature Forcing": 10.0}}}
    jo = JOcean(params)
    to = TOcean(params, device="cpu")
    x = 0.1 * np.random.default_rng(0).standard_normal(jo.state.shape)
    jo.set_state(jnp.asarray(x))
    interop.install_state(to, x)
    return jo, to


def test_transports_match_jax(oceans):
    """Section and path transports to 1e-12; zero at rest."""
    jo, to = oceans
    for kw in ({"i_section": 2}, {"j_section": 3},
               {"i_section": 4, "j_section": 1}):
        jt = jtransports.compute_transports(jo, **kw)
        tt = ttransports.compute_transports(to, **kw)
        assert sorted(tt) == sorted(jt)
        for k in jt:
            np.testing.assert_allclose(tt[k], jt[k], rtol=1e-12)
    for way in ([(0, 3), (6, 3)], [(3, 0), (3, 6)], [(0, 1), (3, 1), (3, 5)]):
        path = ttransports.build_path(way)
        np.testing.assert_array_equal(path, jtransports.build_path(way))
        np.testing.assert_allclose(
            ttransports.compute_path_transport(to, path),
            jtransports.compute_path_transport(jo, path), rtol=1e-12)
    rest = TOcean(dict(to.params.items()), device="cpu")
    tr = tpost.compute_transports(rest, i_section=2, j_section=2)
    assert tr["zonal"] == 0.0 and tr["meridional"] == 0.0


def test_readers_match_jax(tmp_path):
    """read_state, read_eigen, state_to_grid, read_cdata, read_tdata and
    read_profile give what the JAX readers give, on files the port
    wrote."""
    n = m = 3
    l = 2
    flat = np.arange(6 * n * m * l + 1, dtype=float)
    th5.save_state(str(tmp_path / "s.h5"), flat, {"Combined Forcing": 0.25},
                   grid_meta={"z": [0., 1.]})
    vecs = [np.arange(4.0) + 1j, np.ones(4) - 2j]
    th5.save_eigenvectors(str(tmp_path / "ev.h5"), [1 + 2j, 3 + 0j],
                          [1.0, 1.0], vecs)
    (tmp_path / "cdata.txt").write_text(
        "#          par        ds       |x|       |F|   NR  MV\n"
        "0.1 0.01 1.0 1e-9 3 50\n0.2 0.02 2.0 1e-9 4 52\n")
    (tmp_path / "profile_output").write_text(
        "label one          1.25     5   0.25\n"
        "other label        3.5      7   0.5\n")

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(a, b)

    for name, arg in (("read_state", "s.h5"), ("read_eigen", "ev.h5"),
                      ("read_cdata", "cdata.txt"), ("read_tdata", "cdata.txt"),
                      ("read_profile", "profile_output")):
        same(getattr(tpost, name)(str(tmp_path / arg)),
             getattr(jpost, name)(str(tmp_path / arg)))
    same(tpost.state_to_grid(flat, n, m, l),
         jpost.state_to_grid(flat, n, m, l))
    st = tpost.read_state(str(tmp_path / "s.h5"))
    np.testing.assert_array_equal(st["state"], flat)
    assert st["parameters"]["Combined Forcing"] == 0.25


def _drawn(fig):
    """The arrays a figure draws: each QuadMesh's values and each contour
    set's levels, in order."""
    out = []
    for ax in fig.axes:
        for coll in ax.collections:
            a = coll.get_array()
            if a is not None:
                out.append(np.ma.filled(np.asarray(a, dtype=float), np.nan))
        for line in ax.lines:
            out.append(np.asarray(line.get_ydata(), dtype=float))
    return out


def _same_drawing(tfig, jfig, rtol):
    import matplotlib.pyplot as plt
    got, ref = _drawn(tfig), _drawn(jfig)
    plt.close(tfig)
    plt.close(jfig)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-14)


def test_ocean_plots_match_jax(oceans, tmp_path):
    """plot_ocean, plot_overturning and plot_barotropic draw the JAX
    package's arrays (1e-10) and write their files."""
    jo, to = oceans
    for name, kw in (("plot_ocean", {"var": "T"}),
                     ("plot_ocean", {"var": "u", "k": 1}),
                     ("plot_overturning", {}), ("plot_barotropic", {})):
        path = tmp_path / f"{name}{len(kw)}.png"
        _same_drawing(getattr(tpost, name)(to, fname=str(path), **kw),
                      getattr(jpost, name)(jo, **kw), 1e-10)
        assert path.exists()


def test_atmosphere_and_seaice_plots_match_jax(tmp_path):
    """plot_atmosphere and plot_seaice draw the JAX package's arrays for
    every field, from the same states."""
    rng = np.random.default_rng(2)
    pars = {"Global Grid-Size n": 6, "Global Grid-Size m": 4}
    for J, T, fields in ((JAtmosphere, TAtmosphere, "TqA"),
                         (JSeaIce, TSeaIce, "HQMT")):
        jm, tm = J(dict(pars)), T(dict(pars), device="cpu")
        x = rng.standard_normal(jm.dim)
        jm.set_state(jnp.asarray(x))
        interop.install_flat_state(tm, x)
        plot = "plot_atmosphere" if J is JAtmosphere else "plot_seaice"
        for var in fields:
            _same_drawing(getattr(tpost, plot)(tm, var=var),
                          getattr(jpost, plot)(jm, var=var), 0.0)
    import matplotlib.pyplot as plt
    plt.close(tpost.plot_seaice(tm, "M", fname=str(tmp_path / "ice.png")))
    assert (tmp_path / "ice.png").exists()


def test_bifurcation_plot_matches_jax(tmp_path):
    """read_cdata and plot_bif of the plotting module, as
    test_cdata_parse_and_plot."""
    p = tmp_path / "cdata.txt"
    p.write_text("#  par ds ||x|| ||F|| NR MV maxpsi minpsi\n"
                 "0.1 0.01 1.0 1e-9 3 50 0.5 -0.5\n"
                 "0.2 0.02 2.0 1e-9 3 52 0.8 -0.8\n")
    from iemic_tpu.post import plotting as jplotting
    from iemic_tpu_torch.post import plotting as tplotting
    np.testing.assert_array_equal(tplotting.read_cdata(str(p)),
                                  jplotting.read_cdata(str(p)))
    _same_drawing(tpost.plot_bif(str(p), fname=str(tmp_path / "bif.png")),
                  jpost.plot_bif(str(p)), 0.0)
    assert (tmp_path / "bif.png").exists()
