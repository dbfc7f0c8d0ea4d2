"""The port's repairs of two faults it had copied from the JAX package
(ROADMAP queue 3 A): the corrector no longer takes the small update of a
stalled solve for convergence (A1), and each BGS block's multigrid takes
its own prolongation weight (A2)."""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from iemic_tpu.continuation import Continuation as JContinuation
from iemic_tpu.models.ocean import Ocean as JOcean
from iemic_tpu.utils import logging as jlog

from iemic_tpu_torch.continuation import Continuation as TContinuation
from iemic_tpu_torch.models.ocean import Ocean as TOcean
from iemic_tpu_torch.solvers import bgs as tbgs
from iemic_tpu_torch.solvers import factory as tfactory
from iemic_tpu_torch.utils import logging as tlog

from test_torch_ocean import CASES, DATA


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
    """Quiet logs, and no cdata.txt: a continuation writes one where an
    earlier test of the worker left the cdata file set."""
    jlog.set_verbose(False)
    tlog.set_verbose(False)
    jlog.set_cdata_file(None)
    tlog.set_cdata_file(None)
    yield
    jlog.set_verbose(True)
    tlog.set_verbose(True)


# ---------------------------------------------------------------------
# A1: the corrector and stalled solves
# ---------------------------------------------------------------------

class _Stalled:
    """F(x, lambda) = x - 1 on four unknowns, whose solve makes no
    progress: it returns 1e-12 b and reports a true relative residual of
    1.0 against a requested 1e-8.  ``lib`` is numpy-like: jax.numpy or
    torch."""

    def __init__(self, lib, array):
        self.lib, self.array = lib, array
        self.state = array(np.zeros(4))
        self.par = 0.0
        self.rhs = self.sol = self.state

    def compute_rhs(self):
        self.rhs = self.state - 1.0

    def compute_jacobian(self):
        pass

    def solve(self, b):
        self.sol = 1e-12 * b
        self.solve_iters, self.solve_relres, self.solve_tol = 1, 1.0, 1e-8
        return self.sol

    def get_state(self, mode="C"):
        return self.state

    def set_state(self, x):
        self.state = x

    def get_rhs(self, mode="C"):
        return self.rhs

    def get_solution(self, mode="C"):
        return self.sol

    def set_par(self, name, value):
        self.par = float(value)

    def get_par(self, name):
        return self.par

    def pre_process(self):
        pass

    def post_process(self):
        pass

    def monitor(self):
        return False

    def write_data(self, describe=False):
        return ""


_ONE_STEP = {"continuation parameter": "Combined Forcing",
             "initial step size": 0.05, "minimum step size": 0.05,
             "destination 0": 1.0, "maximum number of steps": 1,
             "maximum Newton iterations": 3, "Newton tolerance": 1e-2}


def test_corrector_refuses_a_stalled_solve():
    """Under "D" the JAX corrector declares convergence on the tiny
    update of a solve that made no progress and accepts the step (the
    reference defect, ROADMAP queue 3); the port's counts an iterate only
    where the solve reached its request, so Newton fails and the step is
    rejected."""
    jres = JContinuation(_Stalled(jnp, jnp.asarray), dict(_ONE_STEP)).run()
    assert jres.status == 0 and jres.steps == 1
    model = _Stalled(torch, lambda a: torch.as_tensor(a))
    cont = TContinuation(model, dict(_ONE_STEP))
    tres = cont.run()
    assert tres.status != 0 and tres.steps == 0
    assert cont.newton_iter == _ONE_STEP["maximum Newton iterations"]


def test_corrector_unchanged_without_relres():
    """A model that records no relres is held to the update size alone,
    as before: the same stub without solve_relres converges."""
    model = _Stalled(torch, lambda a: torch.as_tensor(a))
    solve = model.solve

    def plain_solve(b):
        x = solve(b)
        del model.solve_relres, model.solve_tol
        return x

    model.solve = plain_solve
    res = TContinuation(model, dict(_ONE_STEP)).run()
    assert res.status == 0 and res.steps == 1


def _stalled_box(cls, **kw):
    """The 16x8x4 periodic box at Combined Forcing 0 with the Columns +
    Double solve at 1e-2 and 100 iterations (the configuration of
    __graft_entry__.py's stage 3, VERDICT weak #2), whose corrector
    solves stall at relative residuals 0.69 and 1.00."""
    return cls({"THCM": {
        "Global Grid-Size n": 16, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Periodic": True, "Coriolis Force": 0,
        "Starting Parameters": {"Combined Forcing": 0.0,
                                "Temperature Forcing": 10.0,
                                "Salinity Forcing": 0.1}}},
        solver_params={"Preconditioning": "Columns", "Precision": "Double",
                       "FGMRES tolerance": 1e-2, "FGMRES iterations": 100},
        **kw)


def test_corrector_refuses_the_stalled_columns_box():
    """The Columns stall on the 16x8x4 box: the JAX corrector accepts the
    first step although its solves stopped at relres about 1; the port's
    rejects it, every corrector solve logged short of 1e-2."""
    t0 = time.perf_counter()
    jo = _stalled_box(JOcean)
    jres = JContinuation(jo, dict(_ONE_STEP)).run()
    assert jres.status == 0 and jres.steps == 1
    to = _stalled_box(TOcean, device="cpu")
    cont = TContinuation(to, dict(_ONE_STEP))
    tres = cont.run()
    assert tres.status != 0 and tres.steps == 0
    corrector = to.solve_log[1:]            # after the initial tangent
    assert corrector and all(r > 1e-2 for _, r in corrector), corrector
    assert max(r for _, r in corrector) > 0.9
    assert time.perf_counter() - t0 < 60


# ---------------------------------------------------------------------
# A2: one prolongation weight per BGS block
# ---------------------------------------------------------------------

def _leaves(obj):
    """The tensors and numbers of a factor tree, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (int, float)):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [v for x in obj for v in _leaves(x)]
    if isinstance(obj, dict):
        return [v for k in sorted(obj) for v in _leaves(obj[k])]
    return []


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def test_each_block_takes_its_own_prolongation_weight():
    """Auv on MG at weight 0 and ATS on MG at 0.25 in their own sublists:
    each block's multigrid equals the one built with its weight for every
    block; the JAX package (factory.py:130) gives both the weight of the
    block read last."""
    o = TOcean(CASES["island8x8x4"](), solver_params={
        "Preconditioning": "BGS", "Precision": "Double"}, data_dir=DATA,
        device="cpu")
    rng = np.random.default_rng(0)
    o.set_state(torch.as_tensor(0.05 * rng.standard_normal(o.state.shape)))
    o.compute_jacobian()

    def factors(**prec):
        build, _ = tfactory.make_preconditioner(
            dict(Method="BGS", **prec), landm=o.landm, periodic=False,
            grid_shape=(o.cfg.l, o.cfg.m, o.cfg.n))
        return build(o.jac)

    both = factors(**{"Auv Solver": {"Precond Method": "MG",
                                     "MG prolongation weight": 0.0},
                      "ATS Solver": {"Precond Method": "MG",
                                     "MG prolongation weight": 0.25}})
    flat = {w: factors(**{"Auv Precond": "MG", "ATS Precond": "MG",
                          "MG prolongation weight": w})
            for w in (0.0, 0.25)}
    _same(both.uv_mg, flat[0.0].uv_mg)
    _same(both.ts_mg, flat[0.25].ts_mg)
    _same(both.spp_simple, flat[0.25].spp_simple)   # the flat default
    with pytest.raises(AssertionError):
        _same(flat[0.0].uv_mg, flat[0.25].uv_mg)
    assert isinstance(both, tbgs.BGSPrec)
