"""The port's partitioned residual and Jacobian, the local Columns
preconditioner and the sharded continuation (iemic_tpu_torch/parallel
assembly.py, halo.py, model.py) against the serial port and the JAX
package, on the CPU over gloo.

One job of four ranks, spawned through the port's own worker
(``multichip.run_ranks``), computes every multi-rank case of this file
once (module fixture); a case on two ranks runs on a group of the first
two.  While the ranks work, this process runs the serial references; the
cases on one rank run in this process, without a process group.
"""

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.continuation import Continuation as JContinuation
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.continuation import Continuation as TContinuation
from iemic_tpu_torch.main import multichip
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.models.ocean import landmask as tlm
from iemic_tpu_torch.parallel import Domain, ShardedOcean, halo_extend
from iemic_tpu_torch.parallel import make_sharded_ops
from iemic_tpu_torch.solvers.preconditioner import (apply_column_prec,
                                                    build_column_blocks)
from iemic_tpu_torch.utils import logging as tlog

sys.path.insert(0, os.path.dirname(__file__))
from test_continuation_2dmoc import make_2dmoc_ocean  # noqa: E402

RANKS = 4
SHAPES = [(1, 4), (4, 1), (2, 2)]
# relative gap of the partitioned F and An to the serial ones
ASSEMBLY_TOL = 1e-13
# the ocean fixture of tests/test_parallel.py:48-78 (8x8x4, periodic)
THCM = {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Periodic": True,
        "Starting Parameters": {"Combined Forcing": 0.3,
                                "Temperature Forcing": 10.0,
                                "Wind Forcing": 1.0}}
WALLED = dict(THCM, Periodic=False)
# 2DMOC 3x8x4 (Mixing 1) of tests/test_parallel.py:244-306, its solver
# (Columns + Double at 1e-8) and the JAX test's continuation parameters
MOC_GRID = dict(n=3, m=8, l=4)
MOC_SOLVER = {"FGMRES tolerance": 1e-8, "FGMRES iterations": 400,
              "Preconditioning": "Columns", "Precision": "Double"}
MOC_SPINUP = 0.3
MOC_CONT = {"continuation parameter": "Combined Forcing",
            "initial step size": 0.05, "maximum step size": 0.05,
            "increase step size": 1.0, "decrease step size": 1.0,
            "destination 0": 1.0, "maximum number of steps": 2,
            "Newton tolerance": 1.0e-8, "maximum Newton iterations": 12}
# the JAX test's bounds on the trajectory (tests/test_parallel.py:303-306)
PAR_TOL, RTOL, ATOL = 1e-5, 1e-3, 1e-6


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


def _random(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _state(thcm, seed):
    n, m, l = (thcm[f"Global Grid-Size {k}"] for k in "nml")
    return 0.01 * _random(seed, (6, l, m, n))


def _moc_thcm():
    """The 2DMOC fixture's THCM list, read back from the JAX fixture."""
    return dict(_moc_thcm_once())


@functools.lru_cache(maxsize=1)
def _moc_thcm_once():
    return make_2dmoc_ocean(**MOC_GRID).params.sublist("THCM").to_dict()


def _seam_landm():
    """The continent of tests/test_parallel.py:_masked_ocean and two
    islands on the periodic seam (the grid's first and last columns),
    finalized by the port."""
    o = TOcean({"THCM": dict(THCM)}, device="cpu")
    landm = o.landm.copy()
    landm[1:, 3:5, 3:6] = 1
    landm[1:, 5:7, 1] = 1
    landm[2:, 2:4, 8] = 1
    return tlm.finalize_mask(landm, o.grid, True)


def _assembly_cases():
    """(name, THCM, rank grid, land mask or None): the cases of the
    partitioned assembly."""
    cases = [(name, thcm, shape, None) for name, thcm in
             (("periodic", THCM), ("walled", WALLED)) for shape in SHAPES]
    cases += [("seam", THCM, shape, _seam_landm()) for shape in SHAPES]
    moc = _moc_thcm()
    cases += [("2dmoc", moc, shape, None) for shape in [(2, 1), (4, 1)]]
    return cases


def _serial_moc():
    """The port's serial two-step trajectory from the spun-up 2DMOC."""
    o = TOcean({"THCM": _moc_thcm()}, solver_params=dict(MOC_SOLVER),
               device="cpu")
    multichip.spinup(o, MOC_SPINUP)
    TContinuation(o, dict(MOC_CONT)).run()
    return o.get_par("Combined Forcing"), o.state.numpy()


def _jax_moc():
    """The JAX package's serial two-step trajectory, spun up as
    tests/test_parallel.py:275-287 spins it up."""
    jo = make_2dmoc_ocean(**MOC_GRID)
    jo.set_par("Combined Forcing", MOC_SPINUP)
    for _ in range(10):
        jo.compute_rhs()
        if float(jnp.linalg.norm(jo.rhs)) < 1e-11:
            break
        jo.compute_jacobian()
        jo.set_state(jo.get_state() + jo.solve(-jo.rhs))
    JContinuation(jo, dict(MOC_CONT)).run()
    return float(jo.get_par("Combined Forcing")), np.asarray(jo.get_state())


def _jax_assembly(thcm, landm, x):
    """The JAX package's F and An at x."""
    jo = JOcean({"THCM": dict(thcm)})
    if landm is not None:
        jo.set_land_mask(landm, finalized=True)
    xj = jnp.asarray(x)
    return (np.asarray(jo._rhs_fn(xj, jo.par, jo.fields, jo.cpl, 0.0)),
            np.asarray(jo._jac_fn(xj, jo.par, jo.fields, jo.cpl)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank case of the file, from one four-rank job:
    results[key] is the list of each rank's result of that job.  While
    the ranks work, this process runs the references: the port's serial
    2DMOC trajectory (results["serial moc"]), the JAX package's
    (results["jax moc"]) and the JAX package's F and An of each assembly
    case (results[("jax", name)])."""
    cdata_dir = str(tmp_path_factory.mktemp("cdata"))
    jobs = {}
    for name, thcm, shape, landm in _assembly_cases():
        jobs[("assembly", name, shape)] = ("assembly", dict(
            thcm=thcm, shape=shape, x=_state(thcm, 7), landm=landm,
            ranks=shape[0] * shape[1]))
    n, m, l = (THCM[f"Global Grid-Size {k}"] for k in "nml")
    for shape in SHAPES:
        for periodic in (False, True):
            jobs[("halo", shape, periodic)] = ("halo", dict(
                x=_random(1, (6, l, m, n)), shape=shape, periodic=periodic,
                depth=2))
    jobs["columns"] = ("columns", dict(thcm=THCM, shape=(2, 2),
                                       x=_state(THCM, 7),
                                       v=_random(5, (6, l, m, n))))
    jobs["continuation"] = ("continuation", dict(
        thcm=_moc_thcm(), shape=(2, 1), solver=dict(MOC_SOLVER),
        cont=dict(MOC_CONT), comb=MOC_SPINUP, workdir=cdata_dir, ranks=2))
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(multichip.run_ranks, RANKS,
                              list(jobs.values()), device="cpu",
                              backend="gloo", timeout_s=300.0)
        refs = {"serial moc": _serial_moc(), "jax moc": _jax_moc()}
        for name, thcm, _, landm in _assembly_cases():
            if ("jax", name) not in refs:
                refs[("jax", name)] = _jax_assembly(thcm, landm,
                                                    _state(thcm, 7))
        out = running.result()
    results = {key: [r[k] for r in out] for k, key in enumerate(jobs)}
    results.update(refs)
    return results


# ---------------------------------------------------------------------------
# (ii) the 2-deep halo
# ---------------------------------------------------------------------------

def _padded(x, periodic, depth):
    """The serial padding of x by depth: zeros in k and j, the x-wrap
    where periodic."""
    mode = ((0, 0), (depth, depth), (depth, depth), (0, 0))
    xp = np.pad(x, mode)
    if periodic:
        xp = np.pad(xp, ((0, 0),) * 3 + ((depth, depth),), mode="wrap")
    else:
        xp = np.pad(xp, ((0, 0),) * 3 + ((depth, depth),))
    return xp


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shape", SHAPES + [(1, 1)])
def test_halo_depth2_matches_serial_padding(ranks, shape, periodic):
    """Every rank's block padded to depth 2 equals its window of the
    serial 2-deep padding of the global array, exactly (corners
    included: the x stage sends the y-extended block's edge columns)."""
    n, m, l = (THCM[f"Global Grid-Size {k}"] for k in "nml")
    x = _random(1, (6, l, m, n))
    if shape == (1, 1):
        dom = Domain(n, m, l, periodic=periodic, device="cpu")
        from iemic_tpu_torch.parallel import halo_pad_shard
        got = [{"ry": 0, "rx": 0, "padded": halo_pad_shard(
            dom.shard_state(torch.as_tensor(x)), dom, 2).numpy()}]
    else:
        got = ranks[("halo", shape, periodic)]
    xp = _padded(x, periodic, 2)
    ml, nl = m // shape[0], n // shape[1]
    assert sorted((r["ry"], r["rx"]) for r in got) == \
        [(y, i) for y in range(shape[0]) for i in range(shape[1])]
    for r in got:
        j0, i0 = r["ry"] * ml, r["rx"] * nl
        np.testing.assert_array_equal(
            r["padded"], xp[:, :, j0:j0 + ml + 4, i0:i0 + nl + 4])


def test_halo_refuses_a_block_narrower_than_its_depth():
    dom = Domain(1, 8, 3, periodic=True, device="cpu")
    x = torch.zeros((6, 3, 8, 1), dtype=torch.float64)
    assert halo_extend(x, dom, 1).shape == (6, 3, 10, 3)
    with pytest.raises(ValueError, match="at least 2 wide"):
        halo_extend(x, dom, 2)


# ---------------------------------------------------------------------------
# (i) the partitioned residual and Jacobian
# ---------------------------------------------------------------------------

def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("name", ["periodic", "walled", "seam", "2dmoc"])
def test_partitioned_assembly_matches_serial_and_jax(ranks, name):
    """On every rank grid of the case, each rank's gathered F and An equal
    the port's serial Ocean._rhs and Ocean._jacobian to ASSEMBLY_TOL
    (computed on the rank, with the domain's gather refusing inside rhs
    and jac), and the JAX package's _rhs_fn and _jac_fn likewise."""
    F_ref, An_ref = ranks[("jax", name)]
    for _, _, shape, _ in [c for c in _assembly_cases() if c[0] == name]:
        got = [r for r in ranks[("assembly", name, shape)] if r is not None]
        assert len(got) == shape[0] * shape[1]
        for r in got:
            assert r["F_gap"] <= ASSEMBLY_TOL and r["An_gap"] <= ASSEMBLY_TOL
        assert _rel(got[0]["F"], F_ref) <= ASSEMBLY_TOL, shape
        assert _rel(got[0]["An"], An_ref) <= ASSEMBLY_TOL, shape


@pytest.mark.parametrize("name,thcm", [("periodic", THCM),
                                       ("walled", WALLED)])
def test_partitioned_assembly_on_one_rank(name, thcm):
    """One rank without a process group: F and An equal the serial ones
    exactly, with the gather refusing."""
    o = TOcean({"THCM": dict(thcm)}, device="cpu")
    dom = Domain(8, 8, 4, periodic=thcm["Periodic"], device="cpu")
    ops = make_sharded_ops(o, dom)
    x = o._tensor(_state(thcm, 7))
    dom.gather = multichip._refuse_gather
    F, An = ops["rhs"](x, o.par), ops["jac"](x, o.par)
    assert torch.equal(F, o._rhs(x, o.par))
    assert torch.equal(An, o._jacobian(x, o.par))


# ---------------------------------------------------------------------------
# (iii) the local Columns preconditioner
# ---------------------------------------------------------------------------

def test_local_columns_apply_matches_serial(ranks):
    """The column blocks built and applied on each rank's block (no
    gather) equal the serial apply_column_prec on the whole vector."""
    o = TOcean({"THCM": dict(THCM)}, device="cpu")
    An = o._jacobian(o._tensor(_state(THCM, 7)), o.par)
    n, m, l = (THCM[f"Global Grid-Size {k}"] for k in "nml")
    z = apply_column_prec(build_column_blocks(An),
                          o._tensor(_random(5, (6, l, m, n)))).numpy()
    for got in ranks["columns"]:
        np.testing.assert_allclose(got, z, rtol=0,
                                   atol=1e-13 * np.abs(z).max())


def test_sharded_columns_solve_is_serial_on_one_rank():
    """ShardedOcean's Columns + Double solve on one rank is
    Ocean._solve_operator's (row scaling, deflation): the same
    iterations, relres and solution."""
    solver = {"Preconditioning": "Columns", "Precision": "Double",
              "FGMRES tolerance": 1e-6, "FGMRES iterations": 200}
    o = TOcean({"THCM": dict(THCM)}, solver_params=solver, device="cpu")
    so = ShardedOcean(TOcean({"THCM": dict(THCM)}, solver_params=solver,
                             device="cpu"),
                      Domain(8, 8, 4, periodic=True, device="cpu"))
    x = o._tensor(_state(THCM, 3))
    for model in (o, so):
        model.set_state(x.clone())
        model.compute_rhs()
        model.compute_jacobian()
    z, zs = o.solve(-o.rhs), so.solve(-so.rhs)
    assert (so.solve_iters, so.solve_relres) == (o.solve_iters,
                                                 o.solve_relres)
    assert torch.equal(z, zs)


# ---------------------------------------------------------------------------
# (iv) the sharded continuation, (vi) its cdata
# ---------------------------------------------------------------------------

def test_sharded_continuation_matches_serial(ranks):
    """The counterpart of tests/test_parallel.py::
    test_sharded_continuation_equivalence: two continuation steps of
    2DMOC 3x8x4 spun up to Combined Forcing 0.3, a ShardedOcean on (2,1)
    ranks against the port's serial Ocean, to the JAX test's bounds."""
    par, state = ranks["serial moc"]
    for r in ranks["continuation"][:2]:
        assert r["status"] == 0 and r["steps"] == 2
        assert abs(r["par"] - par) < PAR_TOL, (r["par"], par)
        np.testing.assert_allclose(r["state"], state, rtol=RTOL, atol=ATOL)
    assert ranks["continuation"][2:] == [None, None]


def test_serial_continuation_matches_jax(ranks):
    """The port's serial trajectory (the sharded one's reference) against
    the JAX package's serial one, to the same bounds."""
    par, state = ranks["serial moc"]
    jpar, jstate = ranks["jax moc"]
    assert abs(jpar - par) < PAR_TOL, (jpar, par)
    np.testing.assert_allclose(state, jstate, rtol=RTOL, atol=ATOL)


def test_sharded_continuation_writes_cdata_from_rank0(ranks):
    """Each rank of the sharded continuation named its own cdata file:
    only rank 0's exists, with the header and one line per step, psi
    included."""
    got = [r["cdata"] for r in ranks["continuation"][:2]]
    assert got[1] is None
    lines = got[0].splitlines()
    assert lines[0].startswith("#") and "max(psi)" in lines[0]
    rows = [[float(v) for v in line.split()] for line in lines[1:]]
    assert len(rows) == 2 and all(len(row) == 8 for row in rows)
    assert all(np.isfinite(row).all() for row in rows)
