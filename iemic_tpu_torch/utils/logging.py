# Port of iemic_tpu/utils/logging.py (importing iemic_tpu would import jax),
# with the port's span recorder.
"""Logging, nesting wall-clock timers and iteration counters, and the
program's span recorder.

TPU-native analog of the reference's global profiling machinery
(reference src/globaldefs/GlobalDefinitions.H:36-225: INFO/WARNING/ERROR
macros, TIMER_START/STOP nesting timer stack, TRACK_ITERATIONS counters
and printProfile writing ``profile_output``).  The timer stack checks
balance like the reference (GlobalDefinitions.C:222-233).

:func:`timer` is also the program's one span recorder.  Tracing is on
exactly while a PyTorch profiler records
(``torch.autograd._profiler_enabled()``: the benchmark's traced window, or
an operator's ``torch.profiler`` session).

- Tracing off, a timer adds its host wall-clock to the profile table and
  does nothing else: no synchronise, no record.
- Tracing on, each timer is also a span: its body runs inside
  ``torch.profiler.record_function(label)``, so that an exported trace
  shows the program's ranges over the kernels, and on exit a
  :class:`Span` is appended to :data:`spans` with its label, id, the id of
  its parent (the innermost span open on the host), the id of its root
  (shared by every span of one unit of work), and its start and end on
  ``time.time_ns()``, the clock of the profiler's device intervals.  A
  span opened with ``sync=True`` (a boundary: one call into a layer)
  synchronises the CUDA device at both ends, so that its interval holds
  the device work it enqueued; none synchronises while the current
  stream is being captured into a CUDA graph.
- :func:`count` adds to the innermost open span and to the per-label
  total :data:`counters`, tracing on only; :func:`host` is every
  device-to-host read of the solvers' host loops, counted as
  ``host reads``.
"""

from __future__ import annotations

import functools
import itertools
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass

import torch


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
    last: float = 0.0       # seconds of the timer's last call


_profile: dict[str, _Profile] = {}
_stack: list[tuple[str, float]] = []


class Span:
    """One traced timer: label, id, the parent's and the root's id (None
    and its own id at the root), and start and end in ns since the
    epoch; counts holds what :func:`count` added while it was the
    innermost open span."""

    __slots__ = ("label", "id", "parent", "root", "start_ns", "end_ns",
                 "counts")

    def __init__(self, label: str, sid: int, parent, root: int,
                 start_ns: int):
        self.label, self.id, self.parent, self.root = label, sid, parent, root
        self.start_ns, self.end_ns, self.counts = start_ns, 0, {}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


spans: list[Span] = []                  # closed spans, as they close
counters: dict[str, int] = defaultdict(int)
_open: list[Span] = []
_ids = itertools.count(1)
tracing = torch.autograd._profiler_enabled


def reset_profile() -> None:
    _profile.clear()
    _stack.clear()
    spans.clear()
    counters.clear()


def timer_start(label: str) -> None:
    _stack.append((label, time.perf_counter()))


def timer_stop(label: str) -> None:
    if not _stack or _stack[-1][0] != label:
        WARNING(f"unbalanced timer stack: stopping '{label}', "
                f"stack top is '{_stack[-1][0] if _stack else None}'")
    start_label, t0 = _stack.pop()
    entry = _profile.setdefault(start_label, _Profile())
    entry.last = time.perf_counter() - t0
    entry.total += entry.last
    entry.calls += 1


def seconds(label: str) -> float:
    """Seconds of the timer's last call."""
    return _profile[label].last


def _sync() -> None:
    if torch.cuda.is_initialized() and \
            not torch.cuda.is_current_stream_capturing():
        torch.cuda.synchronize()


@contextmanager
def timer(label: str, sync: bool = False):
    """Time the body under label; a span too while tracing is on (see the
    module's docstring), which synchronises at both ends where sync."""
    if not tracing():
        timer_start(label)
        try:
            yield
        finally:
            timer_stop(label)
        return
    if sync:
        _sync()
    sid = next(_ids)
    parent = _open[-1] if _open else None
    span = Span(label, sid, parent and parent.id,
                parent.root if parent else sid, time.time_ns())
    _open.append(span)
    timer_start(label)
    try:
        with torch.profiler.record_function(label):
            yield
            if sync:
                _sync()
    finally:
        span.end_ns = time.time_ns()
        timer_stop(label)
        _open.pop()
        spans.append(span)


def timed(label: str, sync: bool = False):
    """Decorator: every call of the function runs inside timer(label)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with timer(label, sync):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(label: str, n: int = 1) -> None:
    """Add n to the innermost open span and to counters[label], while
    tracing is on."""
    if not tracing():
        return
    counters[label] += n
    if _open:
        c = _open[-1].counts
        c[label] = c.get(label, 0) + n


def host(t: torch.Tensor) -> torch.Tensor:
    """t on the host: one device-to-host read, counted as ``host
    reads``."""
    count("host reads")
    return t.cpu()


def track_iterations(label: str, iters: int) -> None:
    """Record an iteration count (reference TRACK_ITERATIONS)."""
    entry = _profile.setdefault(label, _Profile())
    entry.iters_total += iters
    entry.iters_calls += 1


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


def _primary() -> bool:
    """cdata/tdata writes happen on process 0 only, like the
    reference's rank-0 cdata.txt (GlobalDefinitions.C:88+)."""
    from ..parallel.multihost import is_primary
    return is_primary()


def set_cdata_file(path: str | None) -> None:
    global _CDATA_FILE
    _CDATA_FILE = path
    if path and _primary():
        open(path, "w").close()


def write_cdata(line: str) -> None:
    """Append a line to the continuation data table (cdata.txt)."""
    if not _primary():
        return
    if _CDATA_FILE:
        with open(_CDATA_FILE, "a") as f:
            f.write(line + "\n")
    else:
        INFO(line)
