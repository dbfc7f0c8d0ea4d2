"""Port parity of land-mask swapping, the mask analysis and the
topography homotopy: ``Ocean.set_land_mask``/``get_land_mask``,
``models/ocean/analysis.py``, ``Topo`` and ``run_topo`` against the JAX
package, on the CPU in f64, from the same numpy inputs.

Where the two packages solve, both take the JAX package's solve of the
blended system (f64 FGMRES on the unscaled blended tensor: "Scaling"
"None", Columns, Double at 1e-8), so that their continuations can be
held column by column.  The port's own path under "Mixed" (THCM row
scaling of the blended tensor, the f32 inner solve) is held to the
ocean's solve stack by test_topo_solve_is_the_ocean_stack.
"""

import inspect
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_continuation_2dmoc import CONT_PARS, make_2dmoc_ocean
from test_torch_transient_main import _jax_main
from iemic_tpu.continuation import Continuation as JContinuation
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.models.ocean import analysis as janalysis
from iemic_tpu.models.ocean import landmask as jlm
from iemic_tpu.topo import Topo as JTopo
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch import interop
from iemic_tpu_torch.continuation import Continuation as TContinuation
from iemic_tpu_torch.main import run_topo
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.models.ocean import analysis as tanalysis
from iemic_tpu_torch.models.ocean import landmask as tlm
from iemic_tpu_torch.post import masks as tmasks
from iemic_tpu_torch.topo import Topo as TTopo
from iemic_tpu_torch.utils import logging as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")

# the JAX package's solve of a blended system, in both packages
DOUBLE = {"Preconditioning": "Columns", "Precision": "Double",
          "FGMRES tolerance": 1e-8, "FGMRES iterations": 400}
# one f32 inner solve reaches 5e-3 on the island leg's blended tensor;
# below that the GMRES-IR tail runs 5,000 MV (ROADMAP queue 3)
MIXED = {"Preconditioning": "Columns", "Precision": "Mixed",
         "FGMRES tolerance": 1e-2, "FGMRES iterations": 200}
DIRECT = {"Preconditioning": "Amesos", "FGMRES tolerance": 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch and the BLAS and OpenMP pools on one thread in this module:
    its problems are small, and where several test workers share the
    cores the threads of each small product spin against the other
    workers (measured: a test of this module 7 times slower with the
    default threads)."""
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


def _island(mask="test8x8x4_1", **extra):
    """The masked 8x8x4 grid of tests/test_masks.py under one of the
    repository's test masks."""
    thcm = {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
            "Global Grid-Size l": 4, "Read Land Mask": True,
            "Land Mask": mask,
            "Starting Parameters": {"Combined Forcing": 0.5,
                                    "Temperature Forcing": 10.0,
                                    "Salinity Forcing": 0.1,
                                    "Wind Forcing": 1.0}}
    thcm.update(extra)
    return {"THCM": thcm}


def _pair(params, solver, seed=0):
    """(jax ocean, port ocean) at the same random state."""
    jo = JOcean(params(), solver_params=dict(solver), data_dir=DATA)
    to = TOcean(params(), solver_params=dict(solver), data_dir=DATA,
                device="cpu")
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.standard_normal(np.shape(jo.state))
    jo.set_state(jnp.asarray(x))
    interop.install_state(to, x)
    return jo, to


def _close(got, ref, rtol):
    """Max-norm-scaled comparison."""
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"relative max error {err:.3e} > {rtol:.1e}"


def _F_An(o):
    o.compute_rhs()
    o.compute_jacobian()
    return np.asarray(o.rhs), np.asarray(o.jac)


def test_set_land_mask_reads_mask_fields_again(tmp_path):
    """The salinity perturbation field is zero on land: after a swap to a
    mask with a new surface land cell the port's field is the new mask's,
    where the JAX package keeps the old mask's (ROADMAP queue 3)."""
    path = str(tmp_path / "spert")
    with open(path, "w") as f:
        f.write("\n".join(["0" * 10] * 10) + "\n")
    params = lambda: _island(**{"Read Salinity Perturbation Mask": True,
                                "Salinity Perturbation Mask": path})
    jo, to = _pair(params, DOUBLE)
    raw = np.asarray(to.landm)[1:5, 1:9, 1:9].copy()
    raw[:, 3, 4] = 1                    # a full-depth island
    for o in (jo, to):
        o.set_land_mask(raw)
    want = tlm.read_spert_mask(path, to.grid, to.landm)
    assert want[3, 4] == 0.0
    np.testing.assert_array_equal(to.fields.spert.numpy(), want)
    assert float(jo.fields.spert[3, 4]) == 1.0


def _walled_mask(o, lm=tlm):
    """tests/test_analysis.py's mask: a land block around one isolated
    water column, finalized for the ocean o's grid."""
    landm = np.asarray(o.landm).copy()
    landm[1:, 2:5, 2:5] = 1
    landm[1:, 3, 3] = 0
    return lm.finalize_mask(landm, o.grid, False)


def _walled_column(params):
    """tests/test_analysis.py's 6x6x4 box with the walled-in column, in
    both packages."""
    jo, to = _pair(params, DOUBLE)
    for o, lm in ((jo, jlm), (to, tlm)):
        o.set_land_mask(_walled_mask(o, lm), finalized=True)
        o.compute_jacobian()
    return jo, to


def _box6(sres=0):
    """tests/test_ocean_core.py's make_ocean(n=6, m=6, l=4), by default
    with the salinity integral condition, under which the S column
    analysis applies (see test_fix_cycle_under_salinity_restoring)."""
    return {"THCM": {"Global Grid-Size n": 6, "Global Grid-Size m": 6,
                     "Global Grid-Size l": 4, "Periodic": False,
                     "Global Bound xmin": 286.0, "Global Bound xmax": 350.0,
                     "Global Bound ymin": 10.0, "Global Bound ymax": 74.0,
                     "Coriolis Force": 1, "Restoring Salinity Profile": sres,
                     "Forcing Type": 0, "Topography": 1}}


def test_mask_fix_cycle_matches_jax():
    """On the isolated column of tests/test_analysis.py both packages flag
    the same P rows and S columns, and the fix cycle lands the same cells
    into the same final mask."""
    jo, to = _walled_column(_box6)
    f1j, f1t = janalysis.analyze_jacobian1(jo), tanalysis.analyze_jacobian1(to)
    np.testing.assert_array_equal(f1t, f1j)
    assert (f1t[:, 2, 2] == 2).all()
    np.testing.assert_array_equal(tanalysis.analyze_jacobian2(to),
                                  janalysis.analyze_jacobian2(jo))
    landed = [a.mask_fix_cycle(o, max_fixes=3)
              for a, o in ((janalysis, jo), (tanalysis, to))]
    assert landed[1] == landed[0] >= 4
    np.testing.assert_array_equal(to.landm, np.asarray(jo.landm))
    assert (to.landm[1:5, 3, 3] == 1).all()
    assert (tanalysis.analyze_jacobian1(to) == 2).sum() == 0
    assert (to.landm[1:5, 1:7, 1:7] == 0).any()


def test_fix_cycle_under_salinity_restoring():
    """ROADMAP queue 3.  Under salinity restoring the JAX package's S
    column analysis flags every surface ocean column (the restoring
    coefficient is no masking error) and its fix cycle lands the whole
    ocean; the port's analysis flags no S column there, and its cycle
    lands what the P rows ask, as under the integral condition."""
    jo, to = _walled_column(lambda: _box6(sres=1))
    ocean_top = (np.asarray(jo.landm)[4, 1:7, 1:7] == 0).sum()
    assert (janalysis.analyze_jacobian2(jo) == 2).sum() == ocean_top
    assert (tanalysis.analyze_jacobian2(to) == 0).all()
    janalysis.mask_fix_cycle(jo, max_fixes=3)
    tanalysis.mask_fix_cycle(to, max_fixes=3)
    assert (np.asarray(jo.landm)[1:5, 1:7, 1:7] != 0).all()
    ref = TOcean(_box6(), solver_params=dict(DOUBLE), device="cpu")
    ref.set_land_mask(_walled_mask(ref), finalized=True)
    tanalysis.mask_fix_cycle(ref, max_fixes=3)
    np.testing.assert_array_equal(to.landm, ref.landm)


def test_get_land_mask_adjust_matches_jax(tmp_path):
    """get_land_mask(adjust_mask=True) on tests/test_analysis.py's pinhole
    mask, written by the port's write_mask_file: the same fixed mask in
    both packages, the pinhole landed, no problem P row left."""
    raw = tmasks.create_mask(6, 6, 4)
    raw[:, 1:4, 1:4] = 1
    raw[:, 2, 2] = 0
    path = str(tmp_path / "pinhole")
    tmasks.write_mask_file(path, raw)
    jo, to = _pair(_box6, DOUBLE)
    fixed = [o.get_land_mask(path, adjust_mask=True) for o in (jo, to)]
    np.testing.assert_array_equal(fixed[1], np.asarray(fixed[0]))
    assert (fixed[1][1:5, 3, 3] == 1).all()
    assert to.analyze_jacobian() == 0


def test_integrals_match_jax():
    """Column integrals (with and without the integral-condition row) and
    the salt advection/diffusion integrals of tests/test_analysis.py's
    2DMOC state after one Newton step, to 1e-12 (the column integrals of
    the S-S block's scale, the per-cell fluxes of their largest)."""
    jo = make_2dmoc_ocean(n=3, m=6, l=4)
    jo.set_par("Combined Forcing", 0.5)
    jo.compute_rhs()
    jo.compute_jacobian()
    jo.set_state(jo.state + jo.solve(-jo.rhs))
    to = TOcean({"THCM": jo.params.sublist("THCM").to_dict()},
                solver_params=dict(DOUBLE), device="cpu")
    interop.install_par(to, np.asarray(jo.par))
    interop.install_state(to, np.asarray(jo.state))
    for o in (jo, to):
        o.compute_jacobian()
    # without the integral row the column integrals vanish: held to
    # 1e-12 of the S-S block's largest coefficient
    scale = float(np.abs(np.asarray(jo.jac)[:, 5, 5]).max())
    for sres in (False, True):
        got = tanalysis.column_integral(to, use_sres=sres)
        want = janalysis.column_integral(jo, use_sres=sres)
        assert np.abs(got - want).max() <= 1e-12 * scale
    _close(tanalysis.salt_advection(to), janalysis.salt_advection(jo), 1e-12)
    _close(tanalysis.salt_diffusion(to), janalysis.salt_diffusion(jo), 1e-12)
    cj, ct = jo.integral_checks(), to.integral_checks()
    for key in cj:
        assert abs(ct[key] - cj[key]) <= 1e-12 and abs(ct[key]) < 1e-10


def _install_state(o, x):
    if isinstance(o, JOcean):
        o.set_state(jnp.asarray(x))
    else:
        interop.install_state(o, x)


@pytest.fixture(scope="module")
def island_legs():
    """The leg test8x8x4_1 -> test8x8x4_2 from the same random state and
    x_A in the JAX package, in the port by its own initialize (whose
    ocean first built its Jacobian, factors and deflator under
    test8x8x4_1), and in the port continued from the JAX leg through
    interop.install_topo_leg."""
    jo, to = _pair(_island, MIXED)
    to.compute_jacobian()
    to._get_deflator()
    to._get_prec_factors()
    rng = np.random.default_rng(5)
    x_A = 0.05 * rng.standard_normal(np.shape(jo.state))
    masks = [jo.get_land_mask(f"test8x8x4_{k}")[1:5, 1:9, 1:9]
             for k in (1, 2)]
    x = np.asarray(jo.state)
    legs = []
    for o, Topo in ((jo, JTopo), (to, TTopo)):
        _install_state(o, x_A)
        topo = Topo(o, {"Number of mask files": 0})
        topo.set_masks(masks)
        topo.initialize()
        _install_state(o, x)
        legs.append(topo)
    assert to.jac is None and to._prec_factors is None \
        and to._jacK32 is None and to._deflator is None
    tc = TOcean(_island(), solver_params=dict(MIXED), data_dir=DATA,
                device="cpu")
    interop.install_land_mask(tc, np.asarray(jo.landm))
    interop.install_state(tc, x)
    topo = TTopo(tc, {"Number of mask files": 0})
    interop.install_topo_leg(topo, masks=masks, k=legs[0].k, delta=0.0,
                             state_A=np.asarray(legs[0].state_A),
                             vecM=np.asarray(legs[0].vecM))
    legs.append(topo)
    return legs


def test_set_land_mask_matches_jax(island_legs):
    """After the leg's swap from test8x8x4_1 to test8x8x4_2 the port's F
    and An agree with the JAX package's to 1e-12, and equal those of an
    ocean built under test8x8x4_2: nothing of the old mask is left (the
    fixture checks that its Jacobian, factors, prepared operator and
    deflator went; here the atoms, integral condition and deflator are
    the new mask's)."""
    jo, to = (topo.model for topo in island_legs[:2])
    np.testing.assert_array_equal(to.landm, np.asarray(jo.landm))
    (Fj, Aj), (Ft, At) = _F_An(jo), _F_An(to)
    _close(Ft, Fj, 1e-12)
    _close(At, Aj, 1e-12)

    fresh = TOcean(_island("test8x8x4_2"), solver_params=dict(MIXED),
                   data_dir=DATA, device="cpu")
    fresh.set_state(to.state)
    Ff, Af = _F_An(fresh)
    np.testing.assert_array_equal(fresh.landm, to.landm)
    np.testing.assert_array_equal(Ft, Ff)
    np.testing.assert_array_equal(At, Af)
    np.testing.assert_array_equal(to.int_coeff.numpy(),
                                  fresh.int_coeff.numpy())
    qt, qf = to._get_deflator(), fresh._get_deflator()
    assert (qt is None) == (qf is None)
    if qt is not None:
        np.testing.assert_array_equal(qt.numpy(), qf.numpy())


@pytest.mark.parametrize("delta", [0.0, 0.3, 1.0])
def test_topo_rhs_and_jacobian_match_jax(island_legs, delta):
    """The blended residual and stencil tensor at Delta 0, 0.3 and 1, to
    1e-12, in the port's own leg and in the leg carried over from JAX."""
    jtopo, *ports = island_legs
    np.testing.assert_array_equal(ports[0].model.landm,
                                  np.asarray(jtopo.model.landm))
    _close(ports[0].vecM.numpy(), jtopo.vecM, 1e-14)
    for topo in island_legs:
        topo.set_par("Delta", delta)
        topo.compute_rhs()
        topo.compute_jacobian()
    for topo in ports:
        _close(topo.rhs.numpy(), jtopo.rhs, 1e-12)
        _close(topo.jac.numpy(), jtopo.jac, 1e-12)
        assert abs(topo.norm_fB - jtopo.norm_fB) <= 1e-12 * jtopo.norm_fB


def _nullity_at_delta0(rossby):
    """Nullity of the dense blended Jacobian at Delta 0 of a 4x4x3 North
    Atlantic box (rotation on) on a leg between two ocean-only masks,
    beside the number of pressure modes the deflator removes."""
    sp = {"Combined Forcing": 0.1}
    if rossby is not None:
        sp["Rossby-Number"] = rossby
    o = TOcean({"THCM": {"Global Grid-Size n": 4, "Global Grid-Size m": 4,
                         "Global Grid-Size l": 3, "Coriolis Force": 1,
                         "Starting Parameters": sp}},
               solver_params=dict(DOUBLE), device="cpu")
    topo = TTopo(o, {"Number of mask files": 0})
    topo.set_masks([tmasks.create_mask(4, 4, 3)] * 2)
    topo.initialize()
    topo.compute_jacobian()

    def mv(v):
        return o.to_flat(topo.apply_matrix(o.from_flat(v)))

    n = o.to_flat().numel()
    A = torch.func.vmap(mv)(torch.eye(n, dtype=torch.float64)).T
    s = torch.linalg.svdvals(A)
    return int((s < 1e-12 * s[0]).sum()), o._get_deflator().shape[1]


def test_blended_jacobian_at_delta0_is_singular_with_rotation():
    """ROADMAP queue 3, in both packages alike (their blended tensors
    agree, test_topo_rhs_and_jacobian_match_jax): with a Rossby number
    the u and v rows of the blended Jacobian at Delta 0 are relaxation
    rows, so the pressure is held only by hydrostatic balance, up to a
    constant per water column, and the leg's first tangent solve is
    singular beyond the pressure modes the deflator removes.  With
    Rossby-Number 0 (the 2DMOC configuration, and the smoke run's leg)
    the u and v rows keep their physics and nothing else is singular."""
    nullity, deflated = _nullity_at_delta0(None)
    assert nullity > deflated
    assert _nullity_at_delta0(0.0) == (deflated, deflated)


def _seamount(n, m, l):
    """tests/test_topo.py's mask: one bottom land cell."""
    raw = tmasks.create_mask(n, m, l)
    raw[0, m // 2, n // 2] = 1
    return raw


def _cdata(path):
    rows = [ln.split() for ln in open(path) if not ln.startswith("#")]
    return np.array([[float(v) for v in r] for r in rows])


def test_seamount_leg_matches_jax(tmp_path):
    """tests/test_topo.py's leg (4x6x4, no land -> a bottom seamount,
    Delta 0 -> 1 from the steady state at Combined Forcing 0.1, found by
    Newton with direct solves in the port) in both packages with the JAX package's blended solve (f64,
    unscaled, Columns, 1e-8): cdata par to 1e-8, NR equal, |F| equal where
    above 1e-10, the final states to 1e-6, |F_B| below 1e-6 at Delta 1."""
    n, m, l = 4, 6, 4
    thcm = make_2dmoc_ocean(n=n, m=m, l=l, flat_bottom=False).params \
        .sublist("THCM").to_dict()
    thcm["Scaling"] = "None"
    spin = TOcean({"THCM": thcm}, solver_params=dict(DIRECT), device="cpu")
    spin.set_par("Combined Forcing", 0.1)
    for _ in range(8):
        spin.compute_rhs()
        if float(spin.rhs.norm()) < 1e-12:
            break
        spin.compute_jacobian()
        spin.set_state(spin.state + spin.solve(-spin.rhs))
    assert float(spin.rhs.norm()) < 1e-12
    x_A = spin.state.numpy()
    to = TOcean({"THCM": thcm}, solver_params=dict(DOUBLE), device="cpu")
    jo = JOcean({"THCM": thcm}, solver_params=dict(DOUBLE))
    for o in (jo, to):
        o.set_par("Combined Forcing", 0.1)
        _install_state(o, x_A)
    masks = [tmasks.create_mask(n, m, l), _seamount(n, m, l)]
    tpars = dict(CONT_PARS, **{
        "continuation parameter": "Delta", "destination 0": 1.0,
        "initial step size": 0.2, "maximum step size": 0.5,
        "maximum number of steps": 60})
    out = []
    for o, Topo, Cont, log in ((jo, JTopo, JContinuation, jlog),
                               (to, TTopo, TContinuation, tlog)):
        topo = Topo(o, {"Number of mask files": 0})
        topo.set_masks(masks)
        topo.initialize()
        path = str(tmp_path / f"cdata_{len(out)}.txt")
        log.set_cdata_file(path)
        try:
            assert Cont(topo, tpars).run().status == 0
        finally:
            log.set_cdata_file(None)
        assert abs(topo.delta - 1.0) < 1e-6
        o.compute_rhs()
        out.append((_cdata(path), np.asarray(o.state),
                    float(np.linalg.norm(np.asarray(o.rhs)))))
    (jc, xj, fj), (tc, xt, ft) = out
    assert jc.shape == tc.shape and len(jc) >= 3
    np.testing.assert_allclose(tc[:, 0], jc[:, 0], rtol=1e-8)       # par
    np.testing.assert_array_equal(tc[:, 4], jc[:, 4])              # NR
    big = jc[:, 3] > 1e-10                                          # |F|
    np.testing.assert_allclose(tc[big, 3], jc[big, 3], rtol=1e-3)
    assert np.abs(xt - xj).max() <= 1e-6 * np.abs(xj).max()
    assert fj < 1e-6 and ft < 1e-6
    assert np.all(np.abs(xt[:2, 0, m // 2, n // 2]) < 1e-10)


def test_topo_solve_is_the_ocean_stack(island_legs, monkeypatch):
    """ROADMAP queue 3, finding 1.  Under "Mixed" the JAX Topo.solve gives
    the iterations and solution of its own f64 _solve_fn on the unscaled
    blended tensor.  The port's Topo.solve runs the ocean's stack on the
    row-scaled blended tensor: its f32 inner solve is called, the
    preconditioner is built from R J_h with R the THCM row scale of J_h,
    the tolerance holds in the row-scaled blended system's true residual,
    it equals Ocean.solve on that tensor, and the ocean's jac stays J_B."""
    jtopo, ttopo = island_legs[:2]
    jo, to = jtopo.model, ttopo.model
    for topo in (jtopo, ttopo):
        topo.set_par("Delta", 0.4)
        topo.compute_rhs()
        topo.compute_jacobian()
    b = -np.asarray(jtopo.rhs)

    jtopo.solve(jnp.asarray(b))
    x, iters, _ = jo._solve_fn(
        jtopo.jac, jtopo._jacK32, jo._prec_build(jtopo.jac),
        jtopo._prec_factors32, jnp.asarray(b), MIXED["FGMRES tolerance"],
        jo._get_deflator(), jnp.asarray(1.0))
    assert int(iters) == jo.solve_iters
    np.testing.assert_array_equal(np.asarray(x), np.asarray(jtopo.sol))

    J_B = to.jac
    inner = []
    run_inner = to._inner
    monkeypatch.setattr(to, "_inner",
                        lambda *a: inner.append(1) or run_inner(*a))
    xt = ttopo.solve(torch.as_tensor(b))
    assert inner and to.jac is J_B
    from iemic_tpu_torch.models.ocean import scaling
    R, _ = scaling.row_col_scaling(ttopo.jac, to.landm)
    np.testing.assert_array_equal(to._jac_s.numpy(),
                                  (ttopo.jac * R[None, :, None]).numpy())
    r = (torch.as_tensor(b) - ttopo.apply_matrix(xt)) * R
    nullq = to._get_deflator()
    r = r.reshape(-1) - nullq @ (nullq.T @ r.reshape(-1))
    bs = (torch.as_tensor(b) * R).reshape(-1)
    bs = bs - nullq @ (nullq.T @ bs)
    assert float(r.norm() / bs.norm()) <= MIXED["FGMRES tolerance"]
    mv = to.solve_iters
    to.jac = ttopo.jac
    np.testing.assert_array_equal(to.solve(torch.as_tensor(b)).numpy(),
                                  xt.numpy())
    assert to.solve_iters == mv


def _topo_bundle(path):
    """run/topo cut to 8x8x4 under the repository's test masks
    test8x8x4_1 -> test8x8x4_2, continuing in "Delta" (the shipped bundle
    names mask files that do not exist and continues in "Combined
    Forcing", ROADMAP queue 3), three continuation steps at Newton
    tolerance 1e-2, the JAX package's blended solve.  The leg starts from
    rest, which must solve the blended system at Delta 0: so Combined
    Forcing 0.1 with Rossby-Number 0 (with rotation the blended Jacobian
    is singular at Delta 0,
    test_blended_jacobian_at_delta0_is_singular_with_rotation) and Wind
    Forcing 0 (the wind drives the u, v rows, which Delta 0 keeps)."""
    from iemic_tpu_torch.config import ParameterList, read_xml, write_xml
    shutil.copytree(os.path.join(REPO, "run", "topo"), path)
    op = read_xml(os.path.join(path, "ocean_params.xml"))
    op.set("Save state", False)
    op.set("Data directory", DATA)
    t = op.sublist("THCM")
    for k, v in (("Global Grid-Size n", 8), ("Global Grid-Size m", 8),
                 ("Global Grid-Size l", 4), ("Flat Bottom", False),
                 ("Scaling", "None")):
        t.set(k, v)
    sp = t.sublist("Starting Parameters")
    sp.set("Combined Forcing", 0.1)
    sp.set("Rossby-Number", 0.0)
    sp.set("Wind Forcing", 0.0)
    write_xml(op, os.path.join(path, "ocean_params.xml"))
    tp = read_xml(os.path.join(path, "topo_params.xml"))
    tp.set("Mask file 0", "test8x8x4_1")
    tp.set("Mask file 1", "test8x8x4_2")
    write_xml(tp, os.path.join(path, "topo_params.xml"))
    cp = read_xml(os.path.join(path, "continuation_params.xml"))
    cp.set("continuation parameter", "Delta")
    cp.set("initial step size", 0.2)
    cp.set("Newton tolerance", 1e-2)
    cp.set("maximum number of steps", 3)
    write_xml(cp, os.path.join(path, "continuation_params.xml"))
    write_xml(ParameterList("Solver parameters", dict(DOUBLE)),
              os.path.join(path, "solver_params.xml"))
    return str(path)


def _jax_run_topo(workdir):
    """What the JAX run_topo does in workdir (iemic_tpu/main/run_topo.py),
    with its Topo given the bundle's masks through set_masks: the JAX
    Topo's parameter check refuses a list that names mask files."""
    from iemic_tpu.config import read_xml
    from iemic_tpu.main.run_ocean import read_solver_params
    cwd = os.getcwd()
    os.chdir(workdir)
    jlog.set_cdata_file("cdata.txt")
    try:
        ocean = JOcean(read_xml("ocean_params.xml"),
                       solver_params=read_solver_params())
        tp = read_xml("topo_params.xml")
        topo = JTopo(ocean, {"Number of mask files": 0})
        topo.set_masks([ocean.get_land_mask(tp.get(f"Mask file {i}"))
                        for i in range(tp.get("Number of mask files"))])
        cont = JContinuation(topo, read_xml("continuation_params.xml"))
        topo.set_mask_index(0)
        topo.initialize()
        topo.predictor()
        return cont.run().status
    finally:
        jlog.set_cdata_file(None)
        os.chdir(cwd)


def test_run_topo_matches_jax(tmp_path):
    """run_topo end to end on the cut bundle: the JAX run_topo refuses
    its topo_params.xml (ROADMAP queue 3); the port's gives status 0 and
    the cdata of the JAX Topo driven as run_topo drives it: Delta to
    1e-8, NR equal, |F_B| to 1e-6 where above 1e-10."""
    from iemic_tpu.main import run_topo as jrun_topo
    jdir, tdir = (_topo_bundle(tmp_path / p) for p in ("jax", "port"))
    with pytest.raises(KeyError, match="Mask file 0"):
        _jax_main(jrun_topo.main, jdir)
    assert _jax_run_topo(jdir) == 0
    assert run_topo.main([tdir, "--device", "cpu"]) == 0
    jc, tc = (_cdata(os.path.join(d, "cdata.txt")) for d in (jdir, tdir))
    assert jc.shape == tc.shape and len(jc) == 3
    np.testing.assert_allclose(tc[:, 0], jc[:, 0], rtol=1e-8)       # Delta
    np.testing.assert_array_equal(tc[:, 4], jc[:, 4])              # NR
    big = jc[:, -1] > 1e-10                                         # |fB|
    np.testing.assert_allclose(tc[big, -1], jc[big, -1], rtol=1e-6)
    assert os.path.exists(os.path.join(tdir, "profile_output"))


def test_run_topo_defaults_to_the_card(tmp_path):
    """run_topo runs on the card unless asked for the CPU, and raises
    where there is none."""
    assert inspect.signature(run_topo.run).parameters["device"].default \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_topo.main([str(tmp_path)])
        assert os.listdir(tmp_path) == []
