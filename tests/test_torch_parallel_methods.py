"""The sharded solve runs every method Ocean.solve runs
(iemic_tpu_torch/parallel/methods.py, halo.py's make_sharded_solve and
model.py's ShardedOcean), on the CPU over gloo.

The JAX package's sharded solve is ``Ocean.solve`` on a sharded state
under GSPMD (``iemic_tpu/models/ocean/ocean.py:1014-1077``), so it runs
every method of the factory.  The port runs None, Columns, BGS and Teko
partitioned over the ranks, and Amesos and MILU on the matrix gathered to
rank 0; BGS and Columns/Double are held by tests/test_torch_parallel_solve.py
and tests/test_torch_parallel_bgs.py, the nine other (method, precision)
pairs here:

  (a) on one rank without a process group, ShardedOcean.solve takes
      Ocean.solve's MV and iterate (to SAME_X; measured gap 0 and equal
      MV in all nine);
  (b) on four gloo ranks (2x2, Teko also on 1x4): the same MV on every
      rank, relres within the tolerance, the true (unscaled) residual of
      the gathered iterate within twice it, MV within MV_SLACK of (a)'s;
      the partitioned methods with the domain's gathers refusing in the
      solve, the host methods with the gathers their stats count;
  (c) the partitioned Teko application on 2x2 against the JAX package's
      ``rearranger.apply`` (one and two sweeps, to TEKO_JAX), and the
      rank-0 factor's application against the JAX factory's (Amesos and
      MILU, to HOST_JAX, the bound of tests/test_torch_solvers.py's
      test_factory_method_matches_jax), each on the serial row-scaled
      tensor;
  (d) a method the factory does not know raises the factory's ValueError,
      and the Preconditioner sublist's "Method" decides the method.

The fixture is the 8x8x4 periodic one of tests/test_torch_parallel_solve.py
at the state of seed 11.  PAIRS gives each pair a tolerance it meets
quickly with 200 FGMRES iterations: the Mixed pairs' first refinement
sweep runs to the cap and meets it (so every rank takes the same 200 MV
and no GMRES-IR tail runs), the Double pairs converge (None 34 MV, Teko
162, MILU 37, Amesos 1).  At 1e-6 (where ROADMAP item 19 records the JAX
package's) None and Teko stall at 200 MV under Double and take thousands
under Mixed, as in the JAX package.  Below 1e-3 the MILU solve meets a
plateau, in the serial solve as in the sharded one: rounding alone moves
its MV there (the number of threads does, on this fixture), and the host
solve's implicit residual, whose modified Gram-Schmidt basis loses its
orthogonality there, under-reports the true one, so that a tolerance of
1e-4 or below gives a true residual of more than twice it on four ranks.
So MILU takes 1e-3 here, the card's tolerance for it too (on the masked
8x8x4 grid of chip_smoke.py the serial solve takes 123 MV on the card
and 88 on the CPU there).  One spawn of four ranks runs every multi-rank
case (module fixture) while this process computes the one-rank solves
and the JAX references; about 40 s alone on one thread.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.solvers import factory as jfactory
from iemic_tpu.solvers import rearranger as jre
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.main import multichip
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.parallel import Domain, ShardedOcean
from iemic_tpu_torch.parallel.halo import make_sharded_solve
from iemic_tpu_torch.parallel.methods import PartitionedTeko
from iemic_tpu_torch.solvers import factory as tfactory
from iemic_tpu_torch.utils import logging as tlog

THCM = {"Global Grid-Size n": 8, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Periodic": True,
        "Starting Parameters": {"Combined Forcing": 0.3,
                                "Temperature Forcing": 10.0,
                                "Wind Forcing": 1.0}}
SEED = 11
ITERS = 200
# (method, precision) -> FGMRES tolerance
PAIRS = {("None", "Double"): 1e-2, ("None", "Mixed"): 1e-2,
         ("Columns", "Mixed"): 1e-3,
         ("Teko", "Double"): 1e-3, ("Teko", "Mixed"): 1e-3,
         ("Amesos", "Double"): 1e-8, ("Amesos", "Mixed"): 1e-8,
         ("MILU", "Double"): 1e-3, ("MILU", "Mixed"): 1e-3}
SAME_X = 1e-10
# four ranks against one, in MV: the sums over the ranks round otherwise
# (measured 0 in every pair); MILU factors the gathered tensor, whose row
# scale is summed over the ranks (3.6e-15 from the serial one), and
# decides what to drop on the last bits of an entry
MV_SLACK = {"MILU": 5}
SHAPES = {pair: [(2, 2)] for pair in PAIRS}
SHAPES[("Teko", "Double")] = SHAPES[("Teko", "Mixed")] = [(2, 2), (1, 4)]
FOUR = [(m, p, shape) for (m, p), shapes in SHAPES.items()
        for shape in shapes]
TEKO_JAX = 1e-12
HOST_JAX = 1e-9
# (c): name -> (method, Preconditioner list)
APPLIED = {"Teko, one sweep": ("Teko", {"Teko sweeps": 1}),
           "Teko, two sweeps": ("Teko", {"Teko sweeps": 2}),
           "Amesos": ("Amesos", {}), "MILU": ("MILU", {})}
N, M, L = 8, 8, 4
# the bytes the host methods gather: the stencil tensor once per
# Jacobian, a residual per application
TENSOR_BYTES = 27 * 36 * L * M * N * 8
RESIDUAL_BYTES = 6 * L * M * N * 8


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


def _state():
    return 0.01 * np.random.default_rng(SEED).standard_normal((6, L, M, N))


def _solver(method, precision, **more):
    return dict({"Preconditioning": method, "Precision": precision,
                 "FGMRES tolerance": PAIRS.get((method, precision), 1e-3),
                 "FGMRES iterations": ITERS}, **more)


def _at_state(model):
    model.set_state(torch.as_tensor(_state()))
    model.compute_rhs()
    model.compute_jacobian()
    return model


def _ocean(solver):
    return TOcean({"THCM": dict(THCM)}, solver_params=copy.deepcopy(solver),
                  device="cpu")


def _domain():
    return Domain(N, M, L, periodic=True, device="cpu")


def _sharded(solver):
    return ShardedOcean(_ocean(solver), _domain())


def _gap(z, ref) -> float:
    z, ref = np.asarray(z), np.asarray(ref)
    return float(np.abs(z - ref).max() / np.abs(ref).max())


def _scaled(method):
    """The serial ocean's row-scaled Jacobian (for method's solver) and a
    random vector (seed 5)."""
    o = _at_state(_ocean(_solver(method, "Double")))
    o._get_prec_factors()
    return o._jac_s.numpy(), np.random.default_rng(5).standard_normal(
        (6, L, M, N))


def _jax_applied(method, params, An, r):
    """The JAX package's application of method to r on the tensor An."""
    if method == "Teko":
        fac = jre.build(jnp.asarray(An), periodic=True)
        return np.asarray(jre.apply(fac, jnp.asarray(r), periodic=True,
                                    sweeps=params["Teko sweeps"]))
    build, apply = jfactory.make_preconditioner(
        {"Method": method}, landm=None, periodic=True, grid_shape=(L, M, N))
    return np.asarray(apply(build(jnp.asarray(An)), jnp.asarray(r)))


def _one_rank(method, precision):
    """Ocean.solve and the one-rank ShardedOcean.solve of the pair."""
    o = _at_state(_ocean(_solver(method, precision)))
    so = _at_state(_sharded(_solver(method, precision)))
    z, zs = o.solve(-o.rhs), so.solve(-so.rhs)
    return {"mv": o.solve_iters, "relres": o.solve_relres,
            "sharded_mv": so.solve_iters, "sharded_relres": so.solve_relres,
            "gap": _gap(zs.numpy(), z.numpy())}


@pytest.fixture(scope="module")
def ranks():
    """results["four"][method, precision, shape] each rank's
    job_model_solve result, results["applied"][name] each rank's job_prec
    result and the JAX application, results["one"][pair] the one-rank
    solves, results["ocean"] the serial ocean at the state."""
    x = _state()
    jobs = {("four",) + case: ("model_solve", dict(
        thcm=THCM, shape=case[2], x=x, solver=_solver(*case[:2])))
        for case in FOUR}
    tensors = {method: _scaled(method) for method in ("Teko", "Amesos",
                                                      "MILU")}
    for name, (method, params) in APPLIED.items():
        An, r = tensors[method]
        jobs[("applied", name)] = ("prec", dict(
            thcm=THCM, shape=(2, 2), An=An, r=r, method=method,
            params=params))
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(multichip.run_ranks, 4, list(jobs.values()),
                              device="cpu", backend="gloo", timeout_s=300.0)
        one = {pair: _one_rank(*pair) for pair in PAIRS}
        jax_z = {name: _jax_applied(method, params, *tensors[method])
                 for name, (method, params) in APPLIED.items()}
        out = running.result()
    results = {"one": one, "four": {}, "applied": {},
               "ocean": _at_state(_ocean(None))}
    for k, key in enumerate(jobs):
        per_rank = [r[k] for r in out]
        if key[0] == "four":
            results["four"][key[1:]] = per_rank
        else:
            results["applied"][key[1]] = (per_rank, jax_z[key[1]])
    return results


@pytest.mark.parametrize("method,precision", list(PAIRS))
def test_one_rank_is_ocean_solve(ranks, method, precision):
    """(a) On one rank without a process group ShardedOcean.solve takes
    Ocean.solve's MV and iterate (to SAME_X) and relres, and meets the
    tolerance."""
    r = ranks["one"][method, precision]
    print(f"{method}/{precision}: Ocean.solve {r['mv']} MV to "
          f"{r['relres']:.3e}, ShardedOcean.solve {r['sharded_mv']} MV to "
          f"{r['sharded_relres']:.3e}, gap {r['gap']:.1e}")
    assert r["sharded_mv"] == r["mv"]
    assert r["gap"] <= SAME_X
    assert r["sharded_relres"] <= PAIRS[method, precision]


def _true_relres(ocean, z) -> float:
    res = ocean.apply_matrix(torch.as_tensor(z)) + ocean.rhs
    return float(torch.linalg.norm(res) / torch.linalg.norm(ocean.rhs))


@pytest.mark.parametrize("method,precision,shape", FOUR)
def test_four_ranks(ranks, method, precision, shape):
    """(b) ShardedOcean.solve on four gloo ranks: the same MV on every
    rank, within MV_SLACK of one rank's; relres within the tolerance, the
    true residual of the gathered iterate within twice it.  None,
    Columns and Teko solve with the domain's gathers refusing and count
    none; Amesos and MILU gather the stencil tensor once (TENSOR_BYTES)
    and the residual once an application (RESIDUAL_BYTES), two message
    rounds an application with the scatter back."""
    tol = PAIRS[method, precision]
    res = ranks["four"][method, precision, shape]
    one = ranks["one"][method, precision]
    true = _true_relres(ranks["ocean"], res[0]["z"])
    print(f"{method}/{precision} on {shape}: {res[0]['mv']} MV (one rank "
          f"{one['mv']}) to {res[0]['relres']:.3e}, true relres "
          f"{true:.3e}, {res[0]['seconds']:.2f} s, {res[0]['gathers']} "
          f"gathers; {res[0]['prec']}")
    assert all(r["mv"] == res[0]["mv"] for r in res)
    assert abs(res[0]["mv"] - one["mv"]) <= MV_SLACK.get(method, 0)
    assert res[0]["relres"] <= tol and true <= 2 * tol
    for r in res:
        s = r["prec"]
        assert s["method"] == method and s["applications"] > 0
        assert np.array_equal(r["z"], res[0]["z"])
        if method in tfactory.HOST_METHODS:
            assert r["gathers"] == 1 + s["applications"]
            assert (s["build_gathers"], s["gathers_per_apply"],
                    s["rounds_per_apply"]) == (1, 1, 2)
            assert s["build_gathered_bytes"] == TENSOR_BYTES
            assert s["gathered_bytes_per_apply"] == RESIDUAL_BYTES
        else:
            assert r["gathers"] == s["build_gathers"] == 0
            assert s["gathers_per_apply"] == 0
        if method == "Teko":
            # one halo exchange of z_Y a sweep: a round for each
            # partitioned axis
            assert s["rounds_per_apply"] == (shape[0] > 1) + (shape[1] > 1)


@pytest.mark.parametrize("name", list(APPLIED))
def test_application_matches_jax(ranks, name):
    """(c) One application of the sharded preconditioner on 2x2, gathered,
    against the JAX package's on the serial row-scaled tensor: Teko's
    partitioned sweep (one and two sweeps: one and three halo exchanges of
    two rounds) to TEKO_JAX, the rank-0 Amesos and MILU factors to
    HOST_JAX."""
    method, params = APPLIED[name]
    per_rank, ref = ranks["applied"][name]
    limit = TEKO_JAX if method == "Teko" else HOST_JAX
    for r in per_rank:
        print(f"{name}: gap to JAX {_gap(r['z'], ref):.2e}; {r['stats']}")
        assert _gap(r["z"], ref) <= limit
        if method == "Teko":
            assert r["stats"]["rounds_per_apply"] == \
                2 * (2 * params["Teko sweeps"] - 1)


def test_unknown_method_raises_from_sharded_ocean():
    """(d) A method the factory does not know raises the factory's own
    ValueError when the ShardedOcean is made."""
    with pytest.raises(ValueError) as serial:
        tfactory.make_preconditioner({"Method": "ILUT"}, landm=None,
                                     periodic=True, grid_shape=(L, M, N))
    with pytest.raises(ValueError) as sharded:
        _sharded(_solver("ILUT", "Double"))
    assert str(sharded.value) == str(serial.value) \
        == "SolverFactory: unknown method 'ILUT'"


def test_unknown_method_raises_from_make_sharded_solve():
    """(d) make_sharded_solve refuses it too, before any build."""
    o = _at_state(_ocean(None))
    with pytest.raises(ValueError, match="unknown method 'ILUT'"):
        make_sharded_solve(o, _domain(), preconditioner="ILUT")


def test_sublist_method_decides(ranks):
    """(d) A Preconditioner sublist whose "Method" is Teko runs Teko, not
    Preconditioning's BGS, as Ocean.solve does: a partitioned Teko
    preconditioner, and the MV and iterate of Ocean.solve, which are
    Preconditioning Teko's."""
    solver = _solver("BGS", "Double", **{"FGMRES tolerance": 1e-3,
                                         "Preconditioner": {"Method":
                                                            "Teko"}})
    o = _at_state(_ocean(solver))
    so = _at_state(_sharded(solver))
    z, zs = o.solve(-o.rhs), so.solve(-so.rhs)
    assert isinstance(so._solve.preconditioner(), PartitionedTeko)
    assert so.solve_iters == o.solve_iters \
        == ranks["one"]["Teko", "Double"]["mv"]
    assert _gap(zs.numpy(), z.numpy()) <= SAME_X
