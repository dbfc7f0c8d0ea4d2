"""Grid diagnostics: the overturning streamfunction (PyTorch).

Port of ``psi_m`` / ``psi_min_max`` of
``iemic_tpu/models/ocean/diagnostics.py`` (the reference's OceanGrid
recomputePsiM, OceanGrid.C:269-345): the cdata max(psi)/min(psi)
columns.
"""

from __future__ import annotations

import numpy as np
import torch

from ...grid import Grid
from . import nonlin


def psi_m(x: torch.Tensor, grid: Grid, landm: np.ndarray) -> torch.Tensor:
    """Meridional overturning streamfunction PsiM(k, j), k = 0..l,
    j = 0..m (nondimensional), accumulated upward only through layers
    deeper than 500 m exactly as the reference does."""
    l, m, n = grid.l, grid.m, grid.n
    U, V, W, P, T, S = nonlin.usol(x, landm, grid.periodic, grid)
    kw = dict(dtype=x.dtype, device=x.device)
    vs = grid.dx * torch.sum(V[1:l + 1, :, 1:n + 1], dim=2)   # (l, m+1)
    cs = torch.as_tensor(np.cos(grid.yv), **kw)[None, :]
    contrib = -cs * vs * grid.dz * torch.as_tensor(grid.dfzT, **kw)[:, None]
    deep = torch.as_tensor(grid.z * grid.hdim < -500.0,
                           device=x.device)[:, None]
    psim = torch.cumsum(torch.where(deep, contrib, 0.0), dim=0) * deep
    return torch.cat([torch.zeros((1, m + 1), **kw), psim], dim=0)


def psi_min_max(x, grid: Grid, landm: np.ndarray) -> tuple[float, float]:
    p = psi_m(x, grid, landm)
    return float(p.max()), float(p.min())
