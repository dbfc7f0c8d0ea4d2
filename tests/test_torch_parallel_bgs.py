"""The partitioned block Gauss-Seidel sweep (iemic_tpu_torch/parallel/bgs.py
and make_sharded_solve's BGS path) against the port's serial sweep and
the JAX package's, on the CPU over gloo.

One job of four ranks, spawned through the port's own worker
(``multichip.run_ranks``), builds and applies every multi-rank case of
this file once (module fixture), with the domain's gather refusing
throughout; while the ranks work, this process computes the serial
references (the port's ``bgs.build``/``bgs.apply`` on the whole tensor,
and the JAX package's).  The cases on one rank run in this
process, without a process group.

The grids: the masked 16x10x3 grid (a continent) periodic with the
salinity integral condition, and closed without it, whose multigrids have
two levels and whose level-0 blocks have an odd side on 2x2 (blocks 5x8:
the 2x2 aggregates of rows 4-5 straddle two ranks) and 10x4 on 1x4; and
the masked 8x8x4 fixture of tests/test_parallel.py, whose multigrid has
one level.

The bounds.  The serial sweep itself moves with the rounding of its inner
FGMRES's sums: a relative perturbation of 1e-15 of the saddle FGMRES's
inner products moves the periodic grid's sweep by 4e-9 with two
iterations, 8e-7 with five and 2.7e-5 with the default thirty (measured
on the CPU), and a sum over four ranks rounds otherwise than the serial
sum.  With one saddle iteration (``nit_spp`` 1) rounding is all that
differs, and the partitioned sweep is held to the serial and the JAX
sweep to TIGHT, on every grid and in every case of SWEEPS that takes
one saddle iteration but those of the next paragraph (measured 0 to
4.2e-15 against the serial sweep; against the JAX sweep 1.3e-15 to
1.5e-14 on the 16x10x3 grids and
3.9e-13 to 5.9e-13 on the fixture, where the port's serial sweep is
5.5e-13 from the JAX one); with the default thirty to
DEFAULT_LIMIT (measured 9.0e-13 on the fixture, whose saddle converges,
and 4.0e-5 to 1.1e-4 on the 16x10x3 grids).  The f32 sweep of the Mixed
path's cast factors, with one saddle iteration, is held to F32_LIMIT
(measured 4.1e-7 to 5.4e-7).

Two branches amplify rounding by themselves, so one saddle iteration
does not make them tight.  (1) The orderings M2 and M3 precondition the
2D saddle by SIMPLE, whose Chat solve is an inner FGMRES to 1e-6: a
relative perturbation of 1e-15 of the sweep's input moves the serial M2
and M3 sweeps of the periodic grid by 6e-8 to 6e-7, as the inner solve
stops one iteration earlier or later.  M2 solves the 2D saddle first, on
a right-hand side that the sum over the ranks makes whole exactly, and
stays tight against the serial sweep (measured 0 to 5e-16); M3 solves it
after the tracers, whose multigrid rounds otherwise on four ranks
(measured 4.5e-7 on 2x2), so M3 is held to CHAT_LIMIT, and "M3, Jacobi"
(its 2D saddle preconditioned by point-block Jacobi) holds the ordering
to TIGHT.  The port's serial M2, M3 and M2 with MG on Auv are 1.6e-7 to
9.3e-7 from the JAX sweeps on the periodic grid, so those are held to
JAX at CHAT_LIMIT.  (2) On the fixture's 64 columns the 2D saddle's
multigrid is one dense inverse of the singular saddle shifted by 1e-12 of
its scale: LU here and Gauss-Jordan there round otherwise, the shift's
gain of 1e12 makes that 3.7e-4 of the sweep (the partitioned sweep is
2.3e-15 from the port's serial one), so "KRYLOV, MG" is held to JAX there
at SINGULAR_LIMIT.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.solvers import bgs as jbgs
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.main import multichip
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.models.ocean import landmask as tlm
from iemic_tpu_torch.models.ocean.ocean import _to_dtype
from iemic_tpu_torch.parallel import Domain
from iemic_tpu_torch.parallel import bgs as pbgs
from iemic_tpu_torch.parallel.halo import make_sharded_solve
from iemic_tpu_torch.solvers import bgs as tbgs
from iemic_tpu_torch.utils import logging as tlog

RANKS = 4
SHAPES = [(2, 2), (1, 4)]
TIGHT = 1e-12
DEFAULT_LIMIT = 5e-4
CHAT_LIMIT = 5e-6
SINGULAR_LIMIT = 1e-3
F32_LIMIT = 5e-6
FORCING = {"Combined Forcing": 0.3, "Temperature Forcing": 10.0,
           "Wind Forcing": 1.0}
# name -> (THCM, the land cells of its continent, seed of its state)
GRIDS = {
    "periodic": ({"Global Grid-Size n": 16, "Global Grid-Size m": 10,
                  "Global Grid-Size l": 3, "Periodic": True,
                  "Restoring Salinity Profile": 0,
                  "Starting Parameters": FORCING},
                 (slice(4, 7), slice(5, 9)), 1),
    "closed": ({"Global Grid-Size n": 16, "Global Grid-Size m": 10,
                "Global Grid-Size l": 3, "Periodic": False,
                "Starting Parameters": FORCING},
               (slice(4, 7), slice(5, 9)), 2),
    "fixture": ({"Global Grid-Size n": 8, "Global Grid-Size m": 8,
                 "Global Grid-Size l": 4, "Periodic": True,
                 "Starting Parameters": FORCING},
                (slice(3, 5), slice(3, 6)), 11),
}
# name -> (bgs.apply's keywords, bgs.build's keywords over the sharded
# solve's build, pbgs.SHARDED_BUILD); the first of each grid's also runs
# in f32.  The branches of the depth-averaged 2D saddle (scheme KRYLOV,
# orderings M2 and M3) take one saddle and one Auv iteration; the rho/mu
# transform runs under M1/SI with MG on ATS, MG on Auv under M2
ONE = {"nit_spp": 1, "nit_uv": 1}
SWEEPS = {"SI": ({"nit_spp": 1}, {}), "SI default": ({}, {}),
          "SL": ({"spp_scheme": "SL", "nit_spp": 1}, {}),
          "SR": ({"spp_scheme": "SR", "nit_spp": 1}, {}),
          "symmetric, ATS FGMRES": ({"symmetric": True, "nit_ts": 2,
                                     "nit_spp": 1}, {}),
          "KRYLOV, Jacobi": (dict(ONE, spp_scheme="KRYLOV"), {}),
          "KRYLOV, MG": (dict(ONE, spp_scheme="KRYLOV"),
                         {"spp_precond": "MG"}),
          "M2": (dict(ONE, permutation=2), {}),
          "M3": (dict(ONE, permutation=3), {}),
          "M3, Jacobi": (dict(ONE, permutation=3, spp_scheme="KRYLOV"), {}),
          "rho/mu": (ONE, {"rhomu": True}),
          "Auv MG": (dict(ONE, permutation=2), {"uv_precond": "MG"})}
NEW = ["KRYLOV, Jacobi", "KRYLOV, MG", "M2", "M3", "M3, Jacobi", "rho/mu",
       "Auv MG"]
# the bound of a case against the serial sweep, and of a grid's case
# against the JAX sweep (TIGHT otherwise; see the module note)
LIMITS = {"SI default": DEFAULT_LIMIT, "M3": CHAT_LIMIT}
JAX_LIMITS = {("periodic", "M2"): CHAT_LIMIT, ("periodic", "M3"): CHAT_LIMIT,
              ("periodic", "Auv MG"): CHAT_LIMIT,
              ("fixture", "KRYLOV, MG"): SINGULAR_LIMIT}
CASES = {"periodic": list(SWEEPS), "closed": ["SI", "SI default"],
         "fixture": ["SI", "SI default"] + NEW}
# the cases held to the JAX package's sweep: each grid's with one saddle
# iteration
JAX_CASES = [(name, case) for name in GRIDS for case in CASES[name]
             if SWEEPS[case][0].get("nit_spp") == 1]
# the sharded solves with the gather refusing, on the dry run's box
# (multichip.dryrun_config), as the dry run's stages 1 and 2 solve
BOX, BOX_STATE = multichip.dryrun_config(None, (2, 2))
SOLVES = {"Double": (multichip.STAGE1_TOL, 40, {"nit_spp": 5}),
          "Mixed": (multichip.STAGE2_TOL, multichip.STAGE2_ITERS,
                    multichip.STAGE2_APPLY)}


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
    jlog.set_verbose(False)
    tlog.set_verbose(False)
    yield
    jlog.set_verbose(True)
    tlog.set_verbose(True)


def _ocean(name):
    """The serial port's ocean of the grid name: its continent, a random
    state (numpy seed), the Jacobian computed."""
    thcm, (rows, cols), seed = GRIDS[name]
    o = TOcean({"THCM": dict(thcm)}, device="cpu")
    landm = o.landm.copy()
    landm[1:, rows, cols] = 1
    o.set_land_mask(tlm.finalize_mask(landm, o.grid, thcm["Periodic"]),
                    finalized=True)
    rng = np.random.default_rng(seed)
    o.set_state(o._tensor(0.01 * rng.standard_normal(tuple(o.state.shape))))
    o.compute_rhs()
    o.compute_jacobian()
    return o


def _r(name):
    thcm, _, seed = GRIDS[name]
    shape = (6,) + tuple(thcm[f"Global Grid-Size {k}"] for k in "lmn")
    return np.random.default_rng(100 + seed).standard_normal(shape)


def _int_row(o):
    return ((o.int_coeff, o.rowintcon, float(o.cfg.int_sign))
            if o.cfg.sres == 0 else None)


def _build(case) -> dict:
    """bgs.build's keywords of the case: its own over the sharded solve's
    build."""
    return dict(pbgs.SHARDED_BUILD, **SWEEPS[case][1])


def _serial(o, case):
    """The serial factors of the case's build."""
    return tbgs.build(o.jac, o.landm, periodic=o.cfg.periodic,
                      int_row=_int_row(o), **_build(case))


def _gap(z, ref) -> float:
    return float(np.abs(z - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def ranks():
    """results[("bgs", grid, shape)] is each rank's job_bgs result,
    results[("solve", precision)] each rank's job_solve result;
    results["serial"][grid] the serial sweeps (f64 by name, and "f32"),
    results["jax"][grid, case] the JAX sweeps of JAX_CASES,
    results["oceans"][grid] the serial oceans."""
    oceans = {name: _ocean(name) for name in GRIDS}
    jobs = {}
    for name, o in oceans.items():
        for shape in SHAPES:
            jobs[("bgs", name, shape)] = ("bgs", dict(
                thcm=GRIDS[name][0], shape=shape, An=o.jac.numpy(),
                r=_r(name), landm=o.landm,
                cases=[SWEEPS[c][0] for c in CASES[name]],
                builds=[SWEEPS[c][1] for c in CASES[name]]))
    for precision, (tol, maxiter, opts) in SOLVES.items():
        jobs[("solve", precision)] = ("solve", dict(
            thcm=BOX, shape=(2, 2), x=BOX_STATE, tol=tol, maxiter=maxiter,
            precision=precision, apply_opts=opts))
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(multichip.run_ranks, RANKS,
                              list(jobs.values()), device="cpu",
                              backend="gloo", timeout_s=300.0)
        serial, jaxz = {}, {}
        for name, o in oceans.items():
            r = torch.as_tensor(_r(name))
            serial[name] = {"bytes": {}}
            for c in CASES[name]:
                f = _serial(o, c)
                serial[name][c] = tbgs.apply(f, r, periodic=o.cfg.periodic,
                                             **SWEEPS[c][0]).numpy()
                serial[name]["bytes"][c] = pbgs.nbytes(o.jac, f)
            serial[name]["f32"] = tbgs.apply(
                _to_dtype(_serial(o, "SI"), torch.float32),
                r.to(torch.float32), periodic=o.cfg.periodic,
                **SWEEPS["SI"][0]).numpy()
        factors = {}
        for name, case in JAX_CASES:
            o = oceans[name]
            key = (name, tuple(sorted(_build(case).items())))
            if key not in factors:
                ir = _int_row(o)
                factors[key] = jbgs.build(
                    jnp.asarray(o.jac.numpy()), np.asarray(o.landm),
                    periodic=o.cfg.periodic, **_build(case),
                    int_row=None if ir is None else (
                        np.asarray(ir[0]), ir[1], ir[2]))
            jaxz[name, case] = np.asarray(jbgs.apply(
                factors[key], jnp.asarray(_r(name)),
                periodic=o.cfg.periodic, **SWEEPS[case][0]))
        out = running.result()
    results = {key: [r[k] for r in out] for k, key in enumerate(jobs)}
    results.update(serial=serial, jax=jaxz, oceans=oceans)
    return results


SWEEP_CASES = [(name, shape, case) for name in GRIDS for shape in SHAPES
               for case in CASES[name]]


@pytest.mark.parametrize("name,shape,case", SWEEP_CASES)
def test_partitioned_sweep_matches_serial(ranks, name, shape, case):
    """Every rank's gathered sweep against the port's serial sweep of the
    same build on the whole tensor: TIGHT with one saddle iteration,
    DEFAULT_LIMIT with the default thirty, CHAT_LIMIT for M3 (see the
    module note)."""
    k = CASES[name].index(case)
    ref = ranks["serial"][name][case]
    limit = LIMITS.get(case, TIGHT)
    for r in ranks[("bgs", name, shape)]:
        z = r["sweeps"][k]["z"]
        assert np.isfinite(z).all()
        print(f"{name} {shape} {case}: gap {_gap(z, ref):.2e}")
        assert _gap(z, ref) <= limit


@pytest.mark.parametrize("name,case", JAX_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_sweep_matches_jax(ranks, name, case, shape):
    """The gathered sweep with one saddle iteration against the JAX
    package's bgs.build/bgs.apply on the same tensor and vector (f64), to
    TIGHT: SI, SL, SR and the symmetric sweep with an ATS FGMRES on the
    periodic grid, SI on the closed grid, and on the periodic grid and
    the fixture the branches of NEW (KRYLOV with Jacobi and with MG on
    the 2D saddle, M2, M3, rho/mu, MG on Auv; every MG prolongation
    weight 0.25, as the JAX build takes one); to JAX_LIMITS where the
    port's serial sweep is that far from the JAX one (see the module
    note; its gap is printed beside)."""
    ref = ranks["jax"][name, case]
    k = CASES[name].index(case)
    serial = _gap(ranks["serial"][name][case], ref)
    for r in ranks[("bgs", name, shape)]:
        print(f"{name} {shape} {case}: gap to JAX "
              f"{_gap(r['sweeps'][k]['z'], ref):.2e} (the serial sweep's "
              f"{serial:.2e})")
        assert _gap(r["sweeps"][k]["z"], ref) <= JAX_LIMITS.get(
            (name, case), TIGHT)


@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_f32_sweep(ranks, name, shape):
    """The Mixed path's f32 sweep (the factors cast to f32 once, a tensor
    held twice cast once) against the serial f32 sweep, to F32_LIMIT."""
    ref = ranks["serial"][name]["f32"]
    for r in ranks[("bgs", name, shape)]:
        z32 = r["sweeps"][0]["z32"]
        assert z32.dtype == np.float32
        print(f"{name} {shape} f32: gap {_gap(z32, ref):.2e}")
        assert _gap(z32, ref) <= F32_LIMIT


@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("shape", SHAPES)
def test_per_rank_bytes(ranks, name, shape):
    """Each rank holds its block of the stencil tensor and of the factors,
    and the pieces every rank holds whole: no more than the serial set's
    bytes of the same build / 4 plus those; no gather in any build, and
    message rounds in every sweep, as many on every rank; whole fields
    summed over the ranks in every build and sweep (the coarse levels,
    the 2D saddle's Spp, the Chat V-cycle's input and the 2D saddle's
    right-hand side)."""
    per_sweep = None
    for r in ranks[("bgs", name, shape)]:
        for case, sweep in zip(CASES[name], r["sweeps"]):
            s = sweep["stats"]
            serial = ranks["serial"][name]["bytes"][case]
            print(f"{name} {shape} {case}: {pbgs.format_stats(s)}; serial "
                  f"{serial} bytes")
            assert s["bytes"] <= serial / RANKS + s["replicated_bytes"]
            assert s["build_gathers"] == 0 and s["path"] == "eager"
            assert s["rounds_per_sweep"] > 0
            assert s["build_whole_bytes"] > 0
            assert s["whole_bytes_per_sweep"] > 0
        counts = [sw["stats"]["rounds_per_sweep"] for sw in r["sweeps"]]
        per_sweep = per_sweep or counts
        assert counts == per_sweep


@pytest.mark.parametrize("precision", list(SOLVES))
def test_sharded_solve_never_gathers(ranks, precision):
    """make_sharded_solve's BGS solve, Double and Mixed, on four ranks of
    the dry run's box with the domain's gather refusing in it: within
    its tolerance, its true residual too, the same iterations on every
    rank."""
    o = TOcean({"THCM": dict(BOX)}, device="cpu")
    o.set_state(o._tensor(BOX_STATE))
    o.compute_rhs()
    o.compute_jacobian()
    tol = SOLVES[precision][0]
    res = ranks[("solve", precision)]
    for r in res:
        z = torch.as_tensor(r["z"])
        true = float(torch.linalg.norm(o.apply_matrix(z) + o.rhs)
                     / torch.linalg.norm(o.rhs))
        assert r["relres"] <= tol and true <= 2 * tol
        assert r["mv"] == res[0]["mv"]
        assert r["bgs"]["build_gathers"] == 0 and r["bgs"]["sweeps"] > 0


@pytest.mark.parametrize("name", list(GRIDS))
def test_one_rank_sweep_is_serial_bit_for_bit(ranks, name):
    """On one rank without a process group the partitioned build and
    sweep are the serial ones value for value, f64 and f32, in every case
    of the grid, and count no message round and no whole field summed."""
    o = ranks["oceans"][name]
    thcm = GRIDS[name][0]
    dom = Domain(*(thcm[f"Global Grid-Size {k}"] for k in "nml"),
                 periodic=thcm["Periodic"], device="cpu")
    r = torch.as_tensor(_r(name))
    for case in CASES[name]:
        prec = pbgs.PartitionedBGS(o.jac, o.landm, dom, int_row=_int_row(o),
                                   apply_opts=SWEEPS[case][0],
                                   build_opts=SWEEPS[case][1])
        np.testing.assert_array_equal(prec(r).numpy(),
                                      ranks["serial"][name][case])
        st = prec.stats()
        assert st["rounds_per_sweep"] == st["build_rounds"] == 0
        assert st["whole_bytes_per_sweep"] == st["build_whole_bytes"] == 0
    prec = pbgs.PartitionedBGS(o.jac, o.landm, dom, int_row=_int_row(o),
                               dtype=torch.float32,
                               apply_opts=SWEEPS["SI"][0])
    np.testing.assert_array_equal(prec(r.to(torch.float32)).numpy(),
                                  ranks["serial"][name]["f32"])


@pytest.mark.parametrize("opts", [{"permutation": 4},
                                  dict(ONE, permutation=2, symmetric=True)])
def test_sweep_options_bgs_apply_refuses_raise(ranks, opts):
    """check_branches refuses, before the build, what bgs.apply refuses,
    with bgs.apply's words."""
    o = ranks["oceans"]["fixture"]
    dom = Domain(8, 8, 4, periodic=True, device="cpu")
    with pytest.raises(ValueError) as refused:
        make_sharded_solve(o, dom, apply_opts=opts)
    with pytest.raises(ValueError) as serial:
        tbgs.apply(_serial(o, "SI"), torch.as_tensor(_r("fixture")),
                   periodic=True, **opts)
    assert str(refused.value) == str(serial.value)
