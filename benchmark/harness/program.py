"""The program's own spans and counters, as its span recorder
(``iemic_tpu_torch.utils.logging``) kept them.

The recorder keeps a span or a count only while a PyTorch profiler
records, and a run's only profiler is the traced window's: what it holds
in a run of the harness is the window's.  A program without that record
gives None, and so does each reader built on it.
"""

from __future__ import annotations


def _log():
    try:
        from iemic_tpu_torch.utils import logging as log
    except ImportError:
        return None
    if not hasattr(log, "spans") or not hasattr(log, "counters"):
        return None
    return log


def spans(label: str) -> list | None:
    """The program's closed spans named label (possibly none), or None
    where the program keeps no span record."""
    log = _log()
    return None if log is None else [s for s in log.spans
                                     if s.label == label]


def seconds(label: str) -> list[float] | None:
    """The durations of the spans named label, in s."""
    found = spans(label)
    return None if found is None else [s.seconds for s in found]


def counted(label: str) -> int | None:
    """The counter's total, or None where the program keeps none."""
    log = _log()
    return None if log is None else log.counters.get(label, 0)
