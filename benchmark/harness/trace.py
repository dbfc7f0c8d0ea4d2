"""The profiler's reading of a traced window: device busy time, kernel
time by name, and the idle gaps named by the span the host had open.

Times are the profiler's (CUPTI) device intervals, clipped to the traced
window, whose ends are host times taken after a synchronise.  Only the
device is traced: the spans' host intervals (``harness.spans``) are kept
on the profiler's clock, ns since the epoch, and name the gaps.  Busy time
is the length of the union of the intervals in which an operation (a
kernel, a copy, a memset) ran on the device.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

TOP = 10


def start():
    act = [torch.profiler.ProfilerActivity.CUDA
           if torch.cuda.is_available() else
           torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=act)
    prof.start()
    return prof


def now_ns() -> int:
    """The profiler's clock (ns since the epoch)."""
    return time.time_ns()


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list, cut to width."""
    name = name.removeprefix("void ").replace("(anonymous namespace)",
                                               "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, t0_ns: int, t1_ns: int, spans=()) -> dict:
    """Stop prof and read the window [t0_ns, t1_ns]; spans are the host
    intervals (start ns, end ns, name) that name the idle gaps."""
    prof.stop()
    device, kinds = [], defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA \
            and not e.is_user_annotation()
        kinds["device" if on_device else "host"] += 1
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if on_device:
            a, b = max(a, t0_ns), min(b, t1_ns)
            if b > a:
                device.append((a, b, e.name()))
    busy = _union((a, b) for a, b, _ in device)
    by_name = defaultdict(lambda: [0, 0.0])
    for a, b, name in device:
        by_name[name][0] += 1
        by_name[name][1] += (b - a) * 1e-9
    # idle gaps of the window, each named by the innermost span open on
    # the host where it starts
    gaps, edge = [], t0_ns
    for a, b in busy + [[t1_ns, t1_ns]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle = defaultdict(float)
    spans = sorted(spans)
    for a, b in gaps:
        label = "outside every span"
        for s0, s1, name in spans:
            if s0 > a:
                break
            if s1 >= a:
                label = name
        idle[label] += (b - a) * 1e-9
    return {
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "kernels": {k: tuple(v) for k, v in by_name.items()},
        "device_ops": sorted(([short(k), v[1]] for k, v in by_name.items()),
                             key=lambda r: -r[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda r: -r[1])[:TOP],
        "activities": dict(kinds),
    }
