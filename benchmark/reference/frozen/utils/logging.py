# Copied from iemic_tpu/utils/logging.py (numpy-only; importing iemic_tpu would import jax).
"""The messages and the timer the frozen models call; the reference
reads no timing, so the timer only marks the block."""

from __future__ import annotations

import sys
from contextlib import contextmanager

_VERBOSE = True


def set_verbose(flag: bool) -> None:
    global _VERBOSE
    _VERBOSE = flag


def INFO(*args) -> None:
    if _VERBOSE:
        print(*args, file=sys.stdout)


def WARNING(*args) -> None:
    print("WARNING:", *args, file=sys.stdout)


@contextmanager
def timer(label: str):
    yield
