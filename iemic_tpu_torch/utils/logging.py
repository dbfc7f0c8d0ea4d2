# Copied from iemic_tpu/utils/logging.py (numpy-only; importing iemic_tpu would import jax).
"""Logging, nesting wall-clock timers and iteration counters.

TPU-native analog of the reference's global profiling machinery
(reference src/globaldefs/GlobalDefinitions.H:36-225: INFO/WARNING/ERROR
macros, TIMER_START/STOP nesting timer stack, TRACK_ITERATIONS counters
and printProfile writing ``profile_output``).

Timers here measure host wall-clock around (possibly jitted) blocks; for
kernel-level profiling use torch.profiler traces.  The timer stack checks
balance like the reference (GlobalDefinitions.C:222-233).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


_LOG_STREAM = sys.stdout
_VERBOSE = True
_CDATA_FILE: str | None = None


def set_log_stream(stream) -> None:
    global _LOG_STREAM
    _LOG_STREAM = stream


def set_verbose(flag: bool) -> None:
    global _VERBOSE
    _VERBOSE = flag


def INFO(*args) -> None:
    if _VERBOSE:
        print(*args, file=_LOG_STREAM)


def WARNING(*args) -> None:
    print("WARNING:", *args, file=_LOG_STREAM)


def ERROR(msg: str) -> None:
    raise RuntimeError(msg)


@dataclass
class _Profile:
    total: float = 0.0
    calls: int = 0
    # iteration counters (the reference's _NOTIME_ entries)
    iters_total: int = 0
    iters_calls: int = 0
    samples: list = field(default_factory=list)


_profile: dict[str, _Profile] = {}
_stack: list[tuple[str, float]] = []


def reset_profile() -> None:
    _profile.clear()
    _stack.clear()


def timer_start(label: str) -> None:
    _stack.append((label, time.perf_counter()))


def timer_stop(label: str) -> None:
    if not _stack or _stack[-1][0] != label:
        WARNING(f"unbalanced timer stack: stopping '{label}', "
                f"stack top is '{_stack[-1][0] if _stack else None}'")
    start_label, t0 = _stack.pop()
    entry = _profile.setdefault(start_label, _Profile())
    entry.total += time.perf_counter() - t0
    entry.calls += 1


@contextmanager
def timer(label: str):
    timer_start(label)
    try:
        yield
    finally:
        timer_stop(label)


def track_iterations(label: str, iters: int) -> None:
    """Record an iteration count (reference TRACK_ITERATIONS)."""
    entry = _profile.setdefault(label, _Profile())
    entry.iters_total += iters
    entry.iters_calls += 1
    entry.samples.append(iters)


def profile_table() -> dict[str, dict]:
    out = {}
    for label, p in _profile.items():
        if p.calls:
            out[label] = dict(total=p.total, calls=p.calls,
                              avg=p.total / p.calls)
        else:
            out[label] = dict(total=p.iters_total, calls=p.iters_calls,
                              avg=p.iters_total / max(p.iters_calls, 1))
    return out


def print_profile(path: str | None = None) -> str:
    """Write the profile table (reference GlobalDefinitions.C:220-280)."""
    if _stack:
        WARNING(f"timer stack not empty at print_profile: {_stack}")
    lines = [f"{'label':<50}{'cumul.':>14}{'calls':>10}{'average':>14}"]
    table = profile_table()
    for label in sorted(table):
        e = table[label]
        lines.append(f"{label:<50}{e['total']:>14.6f}{e['calls']:>10d}"
                     f"{e['avg']:>14.6f}")
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def set_cdata_file(path: str | None) -> None:
    global _CDATA_FILE
    _CDATA_FILE = path
    if path:
        open(path, "w").close()


def write_cdata(line: str) -> None:
    """Append a line to the continuation data table (cdata.txt)."""
    if _CDATA_FILE:
        with open(_CDATA_FILE, "a") as f:
            f.write(line + "\n")
    else:
        INFO(line)
