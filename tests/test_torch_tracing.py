"""The port's span recorder (``iemic_tpu_torch.utils.logging``): tracing
off a solve records nothing and never synchronises; under a profiler an
``Ocean.solve`` on the masked 8x8x4 island grid (BGS + Mixed, a few
iterations) records a ``BGS: sweep`` span per preconditioner
application under ``Ocean: solve``, and one ``host reads`` count per
device-to-host read of its Krylov loops; a span starts on the
profiler's clock; spans stay balanced when the body raises."""

import os

import numpy as np
import pytest
import torch

from iemic_tpu_torch import interop
from iemic_tpu_torch.models.ocean import Ocean
from iemic_tpu_torch.models.ocean import ocean as ocean_mod
from iemic_tpu_torch.post.readers import read_profile
from iemic_tpu_torch.solvers import bgs
from iemic_tpu_torch.utils import logging as log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
# a few outer iterations of 4-iteration saddle solves: a solve in 0.2 s
SOLVER = {"Preconditioning": "BGS", "Precision": "Mixed",
          "FGMRES tolerance": 0.5, "FGMRES iterations": 8,
          "Preconditioner": {"Method": "BGS", "Saddlepoint iterations": 4}}


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def ocean():
    """The island grid of tests/test_torch_ocean.py at a random
    stratified state, its Jacobian, factors and deflator built."""
    params = {"THCM": {
        "Global Grid-Size n": 8, "Global Grid-Size m": 8,
        "Global Grid-Size l": 4, "Read Land Mask": True,
        "Land Mask": "test8x8x4_3",
        "Starting Parameters": {"Combined Forcing": 0.5,
                                "Temperature Forcing": 10.0,
                                "Salinity Forcing": 0.1,
                                "Wind Forcing": 1.0}}}
    o = Ocean(params, solver_params=dict(SOLVER), data_dir=DATA,
              device="cpu")
    x = 0.05 * np.random.default_rng(0).standard_normal(
        tuple(o.state.shape))
    x[4] += np.linspace(1.0, -1.0, x.shape[1])[:, None, None]
    interop.install_state(o, x)
    o.compute_rhs()
    o.compute_jacobian()
    o._get_prec_factors()
    o._get_deflator()
    return o


@pytest.fixture
def syncs(monkeypatch):
    """The recorder's synchronise calls, counted."""
    calls = []
    monkeypatch.setattr(log, "_sync", lambda: calls.append(1))
    log.reset_profile()
    yield calls
    log.reset_profile()


def test_tracing_off_records_nothing_and_keeps_the_table(ocean, syncs,
                                                         tmp_path):
    assert not log.tracing()
    ocean.solve(ocean.rhs)
    assert log.spans == [] and dict(log.counters) == {} and syncs == []
    table = log.profile_table()
    assert table["Ocean: solve"]["calls"] == 1
    assert table["Ocean: FGMRES iterations"] == dict(
        total=ocean.solve_iters, calls=1, avg=float(ocean.solve_iters))
    assert table["BGS: sweep"]["calls"] >= ocean.solve_iters
    path = tmp_path / "profile_output"
    log.print_profile(str(path))
    assert read_profile(str(path)).keys() == table.keys()


def test_a_traced_solve_records_each_sweep_under_the_solve(ocean, syncs,
                                                           monkeypatch):
    """One ``BGS: sweep`` per preconditioner application, each below
    ``Ocean: solve``; host reads as the FGMRES structure counts them: a
    read of the two first norms and one of each Hessenberg column per
    ``fgmres_flat`` call, and the Mixed refinement's norms of b, r and
    each pass's new residual."""
    sweeps, outer, inner = [0], [], []
    real_apply, real_flat = ocean._prec_apply, ocean_mod.fgmres_flat

    def counting_apply(factors, r):
        sweeps[0] += 1
        return real_apply(factors, r)

    def recording(into):
        def flat(*a, **kw):
            res = real_flat(*a, **kw)
            into.append(res.iters)
            return res
        return flat

    monkeypatch.setattr(ocean, "_prec_apply", counting_apply)
    monkeypatch.setattr(ocean_mod, "fgmres_flat", recording(outer))
    monkeypatch.setattr(bgs, "fgmres_flat", recording(inner))
    with _profiled():
        assert log.tracing()
        ocean.solve(ocean.rhs)
    assert not log.tracing()
    by_id = {s.id: s for s in log.spans}
    labels = [s.label for s in log.spans]
    assert "Ocean: GMRES-IR tail" not in labels
    sweep_spans = [s for s in log.spans if s.label == "BGS: sweep"]
    assert len(sweep_spans) == sweeps[0] > 0
    (solve,) = [s for s in log.spans if s.label == "Ocean: solve"]
    for s in log.spans:
        assert solve.start_ns <= s.start_ns <= s.end_ns <= solve.end_ns
        assert s.root == solve.id
    for s in sweep_spans:
        up = s
        while up.parent is not None:
            up = by_id[up.parent]
        assert up is solve and s.parent != solve.id
    assert labels.count("FGMRES: orthogonalize") == sum(outer + inner)
    reads = sum(1 + its for its in outer + inner) + 2 + len(outer)
    assert log.counters["host reads"] == reads
    assert sum(s.counts.get("host reads", 0) for s in log.spans) == reads
    # the boundary spans synchronise at both ends: the solve and sweeps
    assert len(syncs) == 2 * (1 + sweeps[0])


def test_a_span_starts_on_the_profilers_clock(syncs):
    label = "tracing test: a span"
    with _profiled() as prof:
        with log.timer(label):
            torch.ones(64).sum()
    (span,) = log.spans
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == label]
    assert len(starts) == 1
    assert abs(starts[0] - span.start_ns) < 5_000_000


def test_spans_stay_balanced_when_the_body_raises(syncs):
    """A raising body closes its span and every span around it, with the
    timer stack; a boundary span whose body raised makes no closing
    synchronise."""
    with _profiled():
        with pytest.raises(ValueError):
            with log.timer("tracing test: outer", sync=True):
                with log.timer("tracing test: inner", sync=True):
                    log.count("tracing test: events", 3)
                    raise ValueError("the body fails")
        log.count("tracing test: events")
    assert log._open == [] and log._stack == []
    inner, outer = log.spans
    assert (inner.label, outer.label) == ("tracing test: inner",
                                          "tracing test: outer")
    assert inner.parent == outer.id and inner.root == outer.root == outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.counts == {"tracing test: events": 3} and outer.counts == {}
    assert log.counters["tracing test: events"] == 4
    assert len(syncs) == 2
    assert log.profile_table()["tracing test: inner"]["calls"] == 1
    with pytest.raises(ValueError):
        with log.timer("tracing test: untraced", sync=True):
            raise ValueError("the body fails")
    assert log._stack == [] and len(log.spans) == 2 and len(syncs) == 2
