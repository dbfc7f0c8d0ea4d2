"""Reaction-coordinate (score) functions for rare-event algorithms
(PyTorch).

Port of ``iemic_tpu/transient/score.py`` (the reference's
ScoreFunctions, src/transient/ScoreFunctions.C:32-190): the normalized,
Gaussian-windowed distance to the A and B states, with an optional third
(unstable) state setting the distance factor, and the ocean variant
restricted to the meridional velocity.  The norms are computed on the
states' device, and one scalar crosses to the host per call.
"""

from __future__ import annotations

import torch


def _score(d1, d2, dist_factor):
    return (dist_factor
            - dist_factor * torch.exp(-0.5 * (d1 / 0.25) ** 2)
            + (1.0 - dist_factor) * torch.exp(-0.5 * (d2 / 0.25) ** 2))


def _score_function(norm, sol1, sol2, sol3):
    nrm = norm(sol1 - sol2)
    dist_factor = 0.5 if sol3 is None else norm(sol1 - sol3) / nrm

    def dist(x) -> float:
        return float(_score(norm(x - sol1) / nrm, norm(x - sol2) / nrm,
                            dist_factor))
    return dist


def default_score_function(sol1, sol2, sol3=None):
    """(ScoreFunctions.C:32-66)"""
    return _score_function(torch.linalg.vector_norm, sol1, sol2, sol3)


def ocean_score_function(sol1, sol2, sol3=None, vvar: int = 1):
    """Ocean variant using only the v-velocity component
    (ScoreFunctions.C:114-190).  States in field layout (6, l, m, n)."""
    return _score_function(lambda x: torch.linalg.vector_norm(x[vvar]),
                           sol1, sol2, sol3)
