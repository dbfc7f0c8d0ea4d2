# Copied from iemic_tpu/utils/hashing.py (numpy-only; importing iemic_tpu would import jax); state_hash also takes a tensor.
"""Deterministic state hashing.

Analog of the reference's ``Utils::hash`` (reference
src/utils/Utils.H:197, Utils.C:333-352): an XOR-and-rotate combine of
per-element hashes, used to compare model states cheaply — e.g. the
synchronization semantics checks of test_coupled.C:828 assert that a
second synchronize() with unchanged inputs leaves every state hash
untouched.

The element hash here is the raw IEEE-754 bit pattern (the reference
uses std::hash<double>, also bit-based), so the hash is exact — any
single-bit state change flips it — and platform-independent.  The
combine is a position-salted splitmix64 mix XOR-reduced over the
array: fully vectorized in numpy (one hash of the production 263k-dof
ocean state costs ~1 ms, not the seconds the original per-element
Python chain took), order-sensitive through the position salt, and
any single-bit change flips the result.
"""

from __future__ import annotations

import numpy as np

_GOLD = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def state_hash(x) -> int:
    """Position-salted splitmix64 XOR-reduction hash of a float array (a
    tensor is taken to the host first)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.float64))
    bits = arr.view(np.uint64).reshape(-1)
    n = bits.size
    if n == 0:
        return 2
    with np.errstate(over="ignore"):
        h = bits + np.arange(1, n + 1, dtype=np.uint64) * _GOLD
        h ^= h >> np.uint64(30)
        h *= _MIX1
        h ^= h >> np.uint64(27)
        h *= _MIX2
        h ^= h >> np.uint64(31)
    return int(np.bitwise_xor.reduce(h) ^ np.uint64(n))


def model_hash(model) -> int:
    """Hash a model's state vector (Utils::hash on getState('V'))."""
    return state_hash(model.get_state())
