"""The benchmark's spans and counters around the calls into the
program's layers.

A span is a host interval around one call into a layer.  In a traced run
it synchronises the device at both ends, so that its interval holds the
device work the call enqueued, and it keeps its interval on the
profiler's clock, so that the trace can say what the host was doing when
the device sat idle.  In an untraced run no span is opened: the drivers
install their wrappers only in a traced run.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.seconds = defaultdict(list)    # name -> [seconds]
        self.counts = defaultdict(list)     # name -> [value]
        self.intervals = []                 # (start ns, end ns, name)
        self.stopped = False

    def stop(self) -> None:
        """Record no further span: what runs after the window, such as
        the check, is no part of a layer's reading."""
        self.stopped = True

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        if self.stopped:
            yield
            return
        self._sync()
        t0, n0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self._sync()
        self.seconds[name].append(time.perf_counter() - t0)
        self.intervals.append((n0, time.time_ns(), name))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Put a span named name around every call of obj.attr."""
        inner = getattr(obj, attr)

        def call(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, attr, call)

    def count(self, name: str, value) -> None:
        self.counts[name].append(value)

    def total(self, name: str) -> float:
        """Seconds of the span summed over the units."""
        return sum(self.seconds.get(name, ()))

    def counted(self, name: str) -> float:
        """The counter summed over the units."""
        return sum(self.counts.get(name, ()))
