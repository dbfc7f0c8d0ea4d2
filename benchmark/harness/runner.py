"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

The cell's traffic mix (``traffic/<name>.json``) names its driver
(``drivers/<name>.py``), whose ``Cell(workdir, traffic, seed, device,
spans)`` does the set-up and whose ``unit()`` runs one unit of work and
returns what the program produced in it.  A driver whose cell runs a
kernel that the program compiles also has ``build()``: set-up calls it
first, and its seconds, which only a checkout's first run spends in
the compiler, are reported apart (they stay part of the set-up).
Units run back to back, each ended by a synchronise, until the window's
seconds have passed; the window's rate counts the units that ended
inside it.  With tracing on, the profiler records the first
``trace_units`` units instead, with the driver's synchronised spans.
Each unit returns what the program produced in it; the harness keeps
them all, or ``check_units`` of them drawn from the seed.  After the
window the driver's ``check(records)`` frees the program and returns
the numbers the reference compares for each kept unit, which the
traffic's ``limits`` bound.
"""

from __future__ import annotations

import math
import os
import tempfile
import time

import numpy as np
import torch

from . import bundle, registry, spans as spans_mod, trace as trace_mod


class Run:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _limits_held(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items() if k in limits)


class _Sample:
    """The units the reference will judge: every unit, or k of them drawn
    from the seed as the units come (reservoir sampling), so that the
    outputs held on the device, and the memory peak with them, do not
    grow with the number of units in the window."""

    def __init__(self, k, seed: int):
        self.k, self.kept = k, []
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, index: int, record) -> None:
        if self.k is None or len(self.kept) < self.k:
            self.kept.append((index, record))
            return
        j = int(self.rng.integers(0, index + 1))
        if j < self.k:
            self.kept[j] = (index, record)

    def records(self) -> list:
        return [r for _, r in sorted(self.kept, key=lambda p: p[0])]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_process: float, device="cuda", spec: dict | None = None,
             config: dict | None = None, bench: str = registry.BENCH) -> Run:
    """Run the cell once on device; t_process is the host clock
    (``time.perf_counter``) at the process's start."""
    spec = registry.benchmark() if spec is None else spec
    cell = registry.cell(spec, cell_name)
    config = registry.config(cell["config"], bench) if config is None \
        else config
    traffic = registry.traffic(cell["traffic"], bench)
    drv = registry.driver(traffic["driver"], bench)
    limits = traffic["limits"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = spans_mod.Spans(device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    build_s = 0.0
    if cuda and hasattr(drv, "build"):
        b0 = time.perf_counter()
        drv.build()
        build_s = time.perf_counter() - b0
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        workdir = bundle.write(config, os.path.join(tmp, "bundle"), bench)
        unit = drv.Cell(workdir, traffic, seed, device,
                        spans if trace else None)
        sync()
        t_start = time.perf_counter()
        setup_s = t_start - t_process
        units, memory, summary = [], [], None
        sample = _Sample(traffic.get("check_units"), seed)
        if trace:
            prof = trace_mod.start()
            tw0 = trace_mod.now_ns()
        while True:
            u0 = time.perf_counter()
            record = unit.unit()
            sync()
            u1 = time.perf_counter()
            sample.offer(len(units), record)
            units.append((u0 - t_start, u1 - t_start))
            if cuda:
                memory.append((torch.cuda.memory_allocated(device),
                               torch.cuda.max_memory_allocated(device)))
            if u1 - t_start >= seconds or (
                    trace and len(units) >= traffic["trace_units"]):
                break
        if trace:
            tw1 = trace_mod.now_ns()
            summary = trace_mod.summarize(prof, tw0, tw1, spans.intervals)
            unit.after_trace(spans)
        spans.stop()
        done = units if trace else [u for u in units if u[1] <= seconds]
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        per_unit = unit.check(sample.records())
        describe = unit.describe()

    numbers = {k: max(u[k] for u in per_unit if k in u)
               for k in limits if any(k in u for u in per_unit)}
    failed = sum(not _limits_held(u, limits) for u in per_unit)
    return Run(cell=cell, config=config, traffic=traffic, seed=seed,
               device=device, seconds=seconds, trace=trace,
               setup_s=setup_s, build_s=build_s, units=units,
               memory=memory, done=done,
               unit_s=(done[-1][1] / len(done)) if done else None,
               peak_bytes=peak, spans=spans, trace_summary=summary,
               numbers=numbers, limits=limits, failed=failed,
               correct=(failed == 0 and set(numbers) == set(limits)
                        and _limits_held(numbers, limits)),
               describe=describe)


def result(run: Run, spec: dict, bench: str = registry.BENCH) -> dict:
    """The result line: the cell's end-to-end metrics (untraced) or its
    per-layer metrics (traced), each from its reader.  Refuses a run
    that was not on the card: no time is reported from one."""
    if run.device.type != "cuda":
        raise RuntimeError("no time is reported from a run off the card")
    section = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(spec, section, run.cell["name"]):
        value = registry.metric(m["name"], bench).read(run)
        if value is None:
            if section == "end_to_end":
                raise RuntimeError(f"no reading of {m['name']}")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    idx = run.device.index or 0
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(idx),
              "count": 1, "memory_peak_bytes": run.peak_bytes}
    line = {"correct": run.correct, "attempted": len(run.units),
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace:
        s = run.trace_summary
        device["busy_s"] = s["busy_s"]
        device["window_s"] = s["window_s"]
        line["breakdown"] = {"device_ops": s["device_ops"],
                             "idle_gaps": s["idle_gaps"]}
    line["setup"] = {"setup_s": run.setup_s, "build_s": run.build_s}
    line["checks"] = {k: {"value": v, "limit": run.limits[k]}
                      for k, v in run.numbers.items()}
    return line
