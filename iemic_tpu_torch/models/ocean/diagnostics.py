"""Grid diagnostics: overturning and barotropic streamfunctions
(PyTorch).

Port of ``iemic_tpu/models/ocean/diagnostics.py`` (the reference's
OceanGrid diagnostics, OceanGrid.C:269-430 recomputePsiM/recomputePsiB,
OceanGrid.H:219 uMax/vMax): the cdata max(psi)/min(psi) columns and the
maximum velocities.
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


def psi_b(x: torch.Tensor, grid: Grid, landm: np.ndarray) -> torch.Tensor:
    """Barotropic streamfunction PsiB(j, i), j = 0..m, i = 0..n: depth
    integral of u, then cumulative meridional integral
    (OceanGrid.C:345-430)."""
    l, n = grid.l, grid.n
    U, V, W, P, T, S = nonlin.usol(x, landm, grid.periodic, grid)
    kw = dict(dtype=x.dtype, device=x.device)
    dzw = (grid.dz * torch.as_tensor(grid.dfzT, **kw))[:, None, None]
    us = torch.sum(U[1:l + 1] * dzw, dim=0)                  # (m+1, n+1)
    avg = 0.5 * (us[:-1, :] + us[1:, :]) * grid.dy           # (m, n+1)
    psib = torch.cumsum(avg, dim=0)
    return torch.cat([torch.zeros((1, n + 1), **kw), psib], dim=0)


def max_velocities(x, grid: Grid, landm: np.ndarray) -> tuple[float, float]:
    """Maximum |u| and |v| (OceanGrid.H:219 uMax/vMax)."""
    U, V, W, P, T, S = nonlin.usol(x, landm, grid.periodic, grid)
    umax, vmax = torch.stack([U.abs().max(), V.abs().max()]).tolist()
    return umax, vmax
