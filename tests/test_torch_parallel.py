"""The port's domain decomposition (iemic_tpu_torch/parallel,
main/multichip.py) against the JAX package's, on the CPU over gloo.

One job of four ranks, spawned through the port's own worker
(``multichip.run_ranks``), computes every multi-rank case of this file
once (module fixture); the cases on one rank run in this process, without
a process group.  The ranks import neither JAX nor the JAX package.

Deep equivalences (Double at 1e-10, Mixed at 1e-8, a Newton step at
1e-10) are marked slow, as tests/test_parallel.py marks them.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.parallel import Domain as JDomain
from iemic_tpu.parallel import decomp2d as jdecomp2d
from iemic_tpu.parallel import make_sharded_stencil_apply as jstencil
from iemic_tpu.parallel.multihost import (
    decomp2d_multihost as jdecomp_mh,
    host_spanning_device_array as jspan)
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.main import multichip
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.models.ocean import landmask as tlm
from iemic_tpu_torch.ops.stencil import pad_state
from iemic_tpu_torch.parallel import Domain, decomp2d, halo_pad_shard
from iemic_tpu_torch.parallel import halo as thalo
from iemic_tpu_torch.parallel.multihost import (
    decomp2d_multihost, host_spanning_device_array, is_primary)
from iemic_tpu_torch.solvers import bgs as tbgs
from iemic_tpu_torch.utils import hdf5 as thdf5
from iemic_tpu_torch.utils import logging as tlog

RANKS = 4
SHAPES = [(2, 2), (1, 4), (4, 1)]
# the grid of the halo and stencil cases (n, m, l): divisible by every
# rank grid above
GRID = (8, 8, 3)
# the ocean fixture of tests/test_parallel.py:48-78 (8x8x4, periodic)
THCM = {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Periodic": True,
        "Starting Parameters": {"Combined Forcing": 0.3,
                                "Temperature Forcing": 10.0,
                                "Wind Forcing": 1.0}}
# the shallow solve of tests/test_parallel.py:142-182
SHALLOW_TOL, SHALLOW_ITERS = 1e-2, 120
# iterations after which the four-rank solve still follows the serial one
# to rounding (see test_sharded_solve_follows_serial_early)
EARLY_ITERS = 3
# the serial port with the sharded Double solve's preconditioner: BGS
# with ATS multigrid and bgs.apply's inner budget (nit_spp 30 to 1e-6),
# no row scaling
SERIAL_SOLVER = {"Preconditioning": "BGS", "Precision": "Double",
                 "FGMRES tolerance": SHALLOW_TOL,
                 "FGMRES iterations": SHALLOW_ITERS,
                 "Preconditioner": {"Saddlepoint iterations": 30,
                                    "Saddlepoint tolerance": 1e-6,
                                    "ATS Precond": "MG"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch and the BLAS and OpenMP pools on one thread in this module,
    as tests/test_torch_topo.py does."""
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


def _random(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _state(seed):
    n, m, l = (THCM[f"Global Grid-Size {k}"] for k in "nml")
    return 0.01 * _random(seed, (6, l, m, n))


def _masked_landm():
    """The continent of tests/test_parallel.py:_masked_ocean, finalized
    by the port (the same mask as the JAX package's)."""
    o = TOcean({"THCM": dict(THCM)}, device="cpu")
    landm = o.landm.copy()
    landm[1:, 3:5, 3:6] = 1
    return tlm.finalize_mask(landm, o.grid, True)


def _serial_masked(solver=None, thcm=None):
    o = TOcean({"THCM": dict(thcm or THCM)}, solver_params=solver,
               device="cpu")
    o.set_land_mask(_masked_landm(), finalized=True)
    o.set_state(o._tensor(_state(11)))
    o.compute_rhs()
    o.compute_jacobian()
    return o


def _halo_x():
    n, m, l = GRID
    return _random(1, (6, l, m, n))


def _stencil_inputs():
    n, m, l = GRID
    rng = np.random.default_rng(42)
    return (rng.standard_normal((27, 6, 6, l, m, n)),
            rng.standard_normal((6, l, m, n)))


def _one_rank_solve(tol, maxiter):
    """The sharded Double solve on one rank, without a process group."""
    so = _serial_masked()
    dom = Domain(8, 8, 4, periodic=True, device="cpu")
    res = thalo.make_sharded_solve(so, dom)(
        dom.shard_stencil(so.jac), dom.shard_state(-so.rhs), tol, maxiter)
    return {"z": res.x.numpy(), "mv": res.mv, "relres": res.relres}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank case of the file, from one four-rank job:
    results[name] is the list of each rank's result of that job.  While
    the ranks work, this process runs the serial solves they are held to:
    results["serial"] is the serial port's Ocean.solve of the shallow
    solve with the sharded Double solve's preconditioner (SERIAL_SOLVER;
    the model and the solution), results["one rank"] and ["one rank
    early"] the sharded solve on one rank, to the shallow tolerance and
    for EARLY_ITERS iterations."""
    gate_dir = str(tmp_path_factory.mktemp("gate"))
    An, x = _stencil_inputs()
    solve = dict(thcm=THCM, shape=(2, 2), x=_state(11),
                 landm=_masked_landm())
    jobs = {}
    for shape in SHAPES:
        for periodic in (False, True):
            jobs[("halo", shape, periodic)] = ("halo", dict(
                x=_halo_x(), shape=shape, periodic=periodic))
            jobs[("stencil", shape, periodic)] = ("stencil", dict(
                An=An, x=x, shape=shape, periodic=periodic))
    jobs["ops"] = ("ops", dict(thcm=THCM, shape=(2, 2), x=_state(7),
                               v=_random(7, (6, 4, 8, 8))))
    jobs["solve"] = ("solve", dict(solve, tol=SHALLOW_TOL,
                                   maxiter=SHALLOW_ITERS))
    jobs["early"] = ("solve", dict(solve, tol=1e-12, maxiter=EARLY_ITERS))
    jobs["gate"] = ("gate", dict(workdir=gate_dir))
    jobs["dryrun"] = ("dryrun", {})
    jobs["modules"] = ("modules", {})
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(multichip.run_ranks, RANKS,
                              list(jobs.values()), device="cpu",
                              backend="gloo", timeout_s=300.0)
        o = _serial_masked(SERIAL_SOLVER, dict(THCM, Scaling="None"))
        serial = (o, o.solve(-o.rhs))
        one = _one_rank_solve(SHALLOW_TOL, SHALLOW_ITERS)
        early = _one_rank_solve(1e-12, EARLY_ITERS)
        out = running.result()
    results = {key: [r[k] for r in out] for k, key in enumerate(jobs)}
    results.update({"serial": serial, "one rank": one,
                    "one rank early": early})
    return results


# ---------------------------------------------------------------------------
# layout: the copied functions against the JAX package's
# ---------------------------------------------------------------------------

class FakeDev:
    """A rank descriptor as tests/test_multihost.py mocks devices."""

    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did


def _devs(nproc, per_proc):
    return [FakeDev(p, p * per_proc + i)
            for p in range(nproc) for i in range(per_proc)]


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n_ranks,n,m", [
    (1, 8, 8), (2, 8, 8), (4, 8, 8), (4, 96, 38), (8, 16, 16), (8, 8, 2),
    (6, 12, 9), (8, 3, 3), (16, 96, 38), (12, 96, 38)])
def test_decomp2d_matches_jax(n_ranks, n, m):
    assert _outcome(decomp2d, n_ranks, n, m) == \
        _outcome(jdecomp2d, n_ranks, n, m)


@pytest.mark.parametrize("nproc,per_proc,py,px,n,m", [
    (1, 8, 2, 4, 96, 32), (4, 4, 4, 4, 16, 16), (2, 8, 4, 4, 96, 32),
    (3, 4, 2, 6, 96, 32), (2, 4, 2, 4, 96, 32), (4, 2, 4, 2, 16, 16)])
def test_multihost_layout_matches_jax(nproc, per_proc, py, px, n, m):
    """host_spanning_device_array and decomp2d_multihost on the mocked
    layouts of tests/test_multihost.py, and more."""
    def ids(fn):
        out = _outcome(fn, _devs(nproc, per_proc), py, px)
        return out if isinstance(out, tuple) else \
            [[(d.process_index, d.id) for d in row] for row in out]

    assert ids(host_spanning_device_array) == ids(jspan)
    assert _outcome(decomp2d_multihost, _devs(nproc, per_proc), n, m) == \
        _outcome(jdecomp_mh, _devs(nproc, per_proc), n, m)


def test_domain_without_process_group():
    """One rank without a process group: the whole grid, no neighbours,
    the I/O rank; a rank grid the group cannot fill raises."""
    assert is_primary()
    dom = Domain(8, 8, 3, periodic=True, device="cpu")
    assert (dom.py, dom.px, dom.size, dom.local_shape) == (1, 1, 1, (8, 8))
    assert (dom.south, dom.north, dom.west, dom.east) == (None,) * 4
    with pytest.raises(ValueError):
        Domain(8, 8, 3, shape=(2, 2), device="cpu")


# ---------------------------------------------------------------------------
# halo exchange and the sharded stencil product
# ---------------------------------------------------------------------------

def _expected_block(x, periodic, ry, rx, py, px):
    n, m, l = GRID
    ml, nl = m // py, n // px
    xp = pad_state(torch.as_tensor(x), periodic)
    return xp[:, :, ry * ml:(ry + 1) * ml + 2,
              rx * nl:(rx + 1) * nl + 2].numpy()


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(1, 1)])
def test_halo_pad_shard_matches_serial_padding(ranks, shape, periodic):
    """Every rank's padded block equals its window of the serial zero (or
    x-periodic) padding of the global array, exactly: these are copies."""
    x = _halo_x()
    if shape == (1, 1):
        dom = Domain(*GRID, periodic=periodic, device="cpu")
        got = [{"ry": 0, "rx": 0, "padded": halo_pad_shard(
            dom.shard_state(torch.as_tensor(x)), dom).numpy()}]
    else:
        got = ranks[("halo", shape, periodic)]
    assert sorted((r["ry"], r["rx"]) for r in got) == \
        [(y, i) for y in range(shape[0]) for i in range(shape[1])]
    for r in got:
        np.testing.assert_array_equal(
            r["padded"], _expected_block(x, periodic, r["ry"], r["rx"],
                                         *shape))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_stencil_matches_jax(ranks, shape, periodic):
    """The gathered four-rank product against the JAX package's shard_map
    product on the same rank grid (4 of the conftest's 8 CPU devices), to
    the tolerance tests/test_parallel.py:34-45 holds JAX to."""
    An, x = _stencil_inputs()
    jdom = JDomain(*GRID, periodic=periodic, shape=shape)
    ref = jstencil(jdom)(jdom.shard_stencil(jnp.asarray(An)),
                         jdom.shard_state(jnp.asarray(x)))
    for y in ranks[("stencil", shape, periodic)]:
        np.testing.assert_allclose(y, np.asarray(ref), rtol=1e-13,
                                   atol=1e-13)


def test_sharded_ops_match_jax(ranks):
    """make_sharded_ops' rhs and matvec (with the integral-condition row,
    owned by one rank of four) against the JAX package's _rhs_fn and
    _apply_fn on the 8x8x4 fixture of tests/test_parallel.py:48-78."""
    jo = JOcean({"THCM": dict(THCM)})
    x, v = jnp.asarray(_state(7)), jnp.asarray(_random(7, (6, 4, 8, 8)))
    F = jo._rhs_fn(x, jo.par, jo.fields, jo.cpl, 0.0)
    An = jo._jac_fn(x, jo.par, jo.fields, jo.cpl)
    Jv = jo._apply_fn(An, v)
    for r in ranks["ops"]:
        np.testing.assert_allclose(r["F"], np.asarray(F), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(r["Jv"], np.asarray(Jv), rtol=1e-12,
                                   atol=1e-12)
        assert r["gap"] <= 1e-13


# ---------------------------------------------------------------------------
# the sharded solve
# ---------------------------------------------------------------------------

def _true_relres(o, z) -> float:
    r = o.apply_matrix(torch.as_tensor(z)) + o.rhs
    return float(torch.linalg.norm(r) / torch.linalg.norm(o.rhs))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_shallow_sharded_solve(ranks, shape):
    """The shallow Double solve of tests/test_parallel.py:142-182 (masked
    8x8x4, tol 1e-2, 120 iterations): relres within the tolerance, the
    true residual of the gathered iterate within twice it.  On one rank
    the solve is the serial port's, iteration for iteration: the same MV
    and the same iterate.  On four ranks the MV is printed beside the
    serial one: the sums over ranks round otherwise, and on this fixture a
    rounding-level difference of the inner products grows by about 40x
    each ten iterations (test_sharded_solve_follows_serial_early), so
    that the MV at 1e-2 moves by several iterations (88 to 101 for
    perturbations of 1e-15 of the serial solve's own inner products)."""
    o, z_serial = ranks["serial"]
    if shape == (1, 1):
        r = ranks["one rank"]
        assert r["mv"] == o.solve_iters
        np.testing.assert_array_equal(r["z"], z_serial.numpy())
    else:
        r = ranks["solve"][0]
        print(f"four ranks (2,2): {r['mv']} MV, serial {o.solve_iters}")
    assert r["relres"] <= SHALLOW_TOL
    assert _true_relres(o, r["z"]) <= 2 * SHALLOW_TOL


def test_sharded_solve_follows_serial_early(ranks):
    """Four ranks compute the serial solve's iteration: after EARLY_ITERS
    iterations the gathered iterate and relres equal the one-rank solve's
    to rounding."""
    one = ranks["one rank early"]
    for r in ranks["early"]:
        assert r["mv"] == one["mv"] == EARLY_ITERS
        assert abs(r["relres"] - one["relres"]) <= 1e-12 * one["relres"]
        np.testing.assert_allclose(r["z"], one["z"], rtol=0,
                                   atol=1e-10 * np.abs(one["z"]).max())


def test_mixed_mv_counts_f32_iterations(monkeypatch):
    """ROADMAP A3: a Mixed sharded solve that ends in the GMRES-IR tail
    reports as MV the f32 preconditioned-operator applications of its
    refinement sweeps and of the tail's inner solves (the unit of
    Ocean._solve_mixed_host), and the tail's f64 iterations apart."""
    sweeps, outer = [0], []
    real_apply, real_host = tbgs.apply, thalo.fgmres_host

    def counting_apply(factors, r, **kw):
        sweeps[0] += r.dtype == torch.float32
        return real_apply(factors, r, **kw)

    def recording_host(*a, **kw):
        dx, res = real_host(*a, **kw)
        outer.append(res.iters)
        return dx, res

    monkeypatch.setattr(tbgs, "apply", counting_apply)
    monkeypatch.setattr(thalo, "fgmres_host", recording_host)
    so = _serial_masked()
    dom = Domain(8, 8, 4, periodic=True, device="cpu")
    solve = thalo.make_sharded_solve(so, dom, precision="Mixed",
                                     apply_opts={"nit_spp": 10, "nit_uv": 6},
                                     inner_tol=1e-2)
    res = solve(dom.shard_stencil(so.jac), dom.shard_state(-so.rhs), 1e-3,
                2)
    assert len(outer) == 1 and outer[0] > 0
    assert res.outer == outer[0]
    assert res.mv == sweeps[0] > res.outer


# ---------------------------------------------------------------------------
# the rank-0 gate, the dry run, the entry point, the ranks' imports
# ---------------------------------------------------------------------------

def test_only_rank0_writes(ranks, tmp_path):
    """save_state and write_cdata write from rank 0 only (the JAX
    package's gate, utils/hdf5.py:25-38 and utils/logging.py:128-144);
    without a process group this process is rank 0 and writes."""
    gate = ranks["gate"]
    assert gate[0] == {"h5": True, "cdata": True}
    assert all(g == {"h5": False, "cdata": False} for g in gate[1:])
    path = str(tmp_path / "cdata.txt")
    tlog.set_cdata_file(path)
    tlog.write_cdata("0 1 2")
    tlog.set_cdata_file(None)
    assert open(path).read() == "0 1 2\n"
    h5 = str(tmp_path / "state.h5")
    thdf5.save_state(h5, np.zeros(4), {"Combined Forcing": 0.0})
    assert os.path.exists(h5)


def test_dryrun_stages(ranks):
    """The dry run's three stages on four ranks (2x2, 8x8x3): the Double
    solve within 1e-2 with its true residual, the Mixed one within 2e-2;
    every rank reports the same iterations; halo bytes as the faces
    give them (a rank sends one y face of 6x3x4, the other side is a wall,
    and two x faces of 6x3x6 f64, periodic).  Stage 3, one continuation
    step of a ShardedOcean on the JAX dry run's 8x8x4 box: accepted, three
    Newton iterations with two solves each after the tangent's, the
    tangent's solve within 1e-2, every rank at the same parameter, the
    state finite."""
    d = ranks["dryrun"]
    assert [(r["ry"], r["rx"]) for r in d] == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    for r in d:
        assert r["relres"] <= multichip.STAGE1_TOL
        assert r["true_relres"] <= 2 * multichip.STAGE1_TOL
        assert r["mixed_relres"] <= multichip.STAGE2_TOL
        assert (r["mv"], r["mixed_mv"]) == (d[0]["mv"], d[0]["mixed_mv"])
        assert r["halo_bytes"] == 8 * (6 * 3 * 4 + 2 * 6 * 3 * 6)
        step = r["step"]
        assert (step["status"], step["steps"], step["newton"]) == (0, 1, 3)
        assert len(step["solves"]) == 7
        assert step["solves"][0][1] <= multichip.STAGE3_SOLVER[
            "FGMRES tolerance"]
        assert step["par"] == d[0]["step"]["par"] > 0
    assert d[0]["update"].shape == (6, 3, 8, 8)
    assert np.isfinite(d[0]["update"]).all()
    assert d[0]["step"]["state"].shape == (6, 4, 8, 8)
    assert np.isfinite(d[0]["step"]["state"]).all()


def test_entry_matches_jax():
    """entry() on the CPU against the root __graft_entry__.entry(): F and
    J F to 1e-12."""
    import __graft_entry__
    fn, (x, par) = multichip.entry(device="cpu")
    F, JF = fn(x, par)
    jfn, jargs = __graft_entry__.entry()
    jF, jJF = jfn(*jargs)
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(JF.numpy(), np.asarray(jJF), rtol=1e-12,
                               atol=1e-12)


def test_entry_points_default_to_the_card():
    """Without a card the entry points raise unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        multichip.entry()
    with pytest.raises(RuntimeError):
        multichip.run_ranks(2, [("modules", {})])
    with pytest.raises(RuntimeError):
        Domain(8, 8, 3)


def test_ranks_import_no_jax(ranks):
    assert ranks["modules"] == [[]] * RANKS


# ---------------------------------------------------------------------------
# deep equivalences (tests/test_parallel.py:111,185,215), slow
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_deep_double_solve(shape):
    """The Double sharded solve at 1e-10 converges on every rank grid,
    with the true residual within 1e-8 (tests/test_parallel.py:111)."""
    o = _serial_masked()
    r = multichip.run_ranks(shape[0] * shape[1], [("solve", dict(
        thcm=THCM, shape=shape, x=_state(11), landm=_masked_landm(),
        tol=1e-10, maxiter=300))], device="cpu")[0][0]
    assert r["relres"] < 1e-9
    assert _true_relres(o, r["z"]) < 1e-8


@pytest.mark.slow
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_deep_mixed_solve(shape):
    """The Mixed sharded solve at 1e-8 (tests/test_parallel.py:185): its
    explicit residual below 1e-8 and the true unscaled residual below
    1e-7."""
    o = _serial_masked()
    o.set_state(o._tensor(_state(17)))
    o.compute_rhs()
    o.compute_jacobian()
    r = multichip.run_ranks(shape[0] * shape[1], [("solve", dict(
        thcm=THCM, shape=shape, x=_state(17), landm=_masked_landm(),
        tol=1e-8, maxiter=300, precision="Mixed"))], device="cpu")[0][0]
    assert r["relres"] < 1e-8
    assert _true_relres(o, r["z"]) < 1e-7


@pytest.mark.slow
def test_deep_newton_step():
    """One Newton step (sharded rhs, jac, Double solve at 1e-10, update)
    on one and on four ranks agrees to the solver tolerance amplified by
    the conditioning (tests/test_parallel.py:215)."""
    out = []
    for shape in [(1, 1), (2, 2)]:
        r = multichip.run_ranks(shape[0] * shape[1], [("newton", dict(
            thcm=THCM, shape=shape, x=_state(13), landm=_masked_landm(),
            tol=1e-10, maxiter=300))], device="cpu")[0][0]
        out.append(r)
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4, atol=1e-7)
