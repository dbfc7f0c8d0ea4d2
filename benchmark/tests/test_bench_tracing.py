"""The readers of the program's spans and counters
(``harness/program.py`` and the metrics built on it), on hand-built
records and runs: each gives the hand-computed value, None where the
program keeps no record, and the readers that were there read the same
whatever the program's record holds."""

import pytest
import torch

from harness import registry, spans as spans_mod
from harness.runner import Run
from iemic_tpu_torch.utils import logging as log

NEW = {"ocean96-corrector": ["sweep_s.ocean", "graph_record_s.ocean",
                             "graphs_per_newton.ocean",
                             "host_reads_per_mv.ocean"],
       "aquaplanet-theta": ["sweep_s.coupled", "coupling_blocks_s.coupled",
                            "host_reads_per_step.coupled"]}
MS = 1_000_000


def _span(label, start_ms, end_ms, sid, parent=None, root=None, **counts):
    s = log.Span(label, sid, parent, sid if root is None else root,
                 start_ms * MS)
    s.end_ns, s.counts = end_ms * MS, dict(counts)
    return s


def _run(units, mv=0):
    """A traced run of len(units) units whose wrappers counted mv MV."""
    spans = spans_mod.Spans(torch.device("cpu"))
    spans.intervals.append((0, 4000 * MS, "solve"))
    spans.seconds["solve"].append(4.0)
    spans.seconds["assembly"].append(0.5)
    spans.count("mv", mv)
    summary = {"window_s": 4.5, "busy_s": 1.5, "kernels": {},
               "device_ops": [], "idle_gaps": [], "activities": {}}
    return Run(units=units, spans=spans, trace_summary=summary, trace=True)


def _record(monkeypatch, spans, counters):
    monkeypatch.setattr(log, "spans", spans)
    monkeypatch.setattr(log, "counters", counters)


def _read(name, run):
    return registry.metric(name).read(run)


def test_the_ocean_readers_give_the_hand_counts(monkeypatch):
    """Two Newton iterations: three sweeps of 0.1, 0.2 and 0.3 s, the
    graphs of each iteration's factor set recorded in 0.05 and 0.07 s
    (two graphs each), 630 reads over 10 MV."""
    _record(monkeypatch, [
        _span("BGS: record graphs", 10, 60, 3, 2, 1),
        _span("BGS: sweep", 0, 100, 2, 1, 1),
        _span("BGS: sweep", 100, 300, 4, 1, 1),
        _span("Continuation: Newton iteration", 0, 1000, 1),
        _span("BGS: record graphs", 1010, 1080, 7, 6, 5),
        _span("BGS: sweep", 1000, 1300, 6, 5, 5),
        _span("Continuation: Newton iteration", 1000, 2000, 5),
    ], {"graphs recorded": 4, "host reads": 630})
    run = _run([(0.0, 1.0), (1.0, 2.0)], mv=10)
    assert _read("sweep_s.ocean", run) == pytest.approx(0.2)
    assert _read("graph_record_s.ocean", run) == pytest.approx(0.06)
    assert _read("graphs_per_newton.ocean", run) == 2.0
    assert _read("host_reads_per_mv.ocean", run) == 63.0


def test_the_coupled_readers_give_the_hand_counts(monkeypatch):
    """Two theta steps: sweeps of 0.1 and 0.3 s, coupling blocks of 0.5,
    0.25 and 0.75 s, 900 reads."""
    _record(monkeypatch, [
        _span("BGS: sweep", 0, 100, 2, 1, 1),
        _span("CoupledModel: coupling blocks", 200, 700, 3, 1, 1),
        _span("BGS: sweep", 1000, 1300, 5, 4, 4),
        _span("CoupledModel: coupling blocks", 1300, 1550, 6, 4, 4),
        _span("CoupledModel: coupling blocks", 1600, 2350, 7, 4, 4),
    ], {"host reads": 900})
    run = _run([(0.0, 1.0), (1.0, 2.5)])
    assert _read("sweep_s.coupled", run) == pytest.approx(0.2)
    assert _read("coupling_blocks_s.coupled", run) == pytest.approx(0.75)
    assert _read("host_reads_per_step.coupled", run) == 450.0


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_program_without_the_record_gives_no_reading(monkeypatch, cell):
    """The parent commit's program keeps no span record: every new
    reader gives None and raises nothing."""
    monkeypatch.delattr(log, "spans")
    run = _run([(0.0, 1.0)], mv=10)
    for name in NEW[cell]:
        assert _read(name, run) is None, name


@pytest.mark.parametrize("cell", sorted(NEW))
def test_the_readers_that_were_there_read_the_same(monkeypatch, cell):
    """What the program recorded moves none of the readers that read the
    benchmark's wrappers and the profiler's summary; each new metric is
    in BENCHMARK.json for its cell."""
    spec = registry.benchmark()
    names = [m["name"] for m in registry.metrics_of(spec, "per_layer", cell)]
    assert set(NEW[cell]) <= set(names)
    old = [n for n in names if n not in NEW[cell]
           and n != "stencil_roofline_pct"]
    run = _run([(0.0, 1.0)], mv=10)
    _record(monkeypatch, [], {})
    before = {n: _read(n, run) for n in old}
    _record(monkeypatch, [_span("BGS: sweep", 0, 100, 1)],
            {"host reads": 7, "mv": 99})
    assert {n: _read(n, run) for n in old} == before
