"""THCM row/column scaling of the ocean Jacobian (PyTorch).

Port of ``iemic_tpu/models/ocean/scaling.py`` (the reference's m_scaling
module, scaling.F90:28-280, THCM::RecomputeScaling THCM.C:1693-1750):
average the 6x6 center block over OCEAN cells, derive per-variable
row/column factors with the 'THCM 6.0' recipe, map them to grid vectors
(1 on land) and give T and S identical factors per cell.  Only the row
scaling is applied by the solve (Ocean.C:1206-1214).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.stencil import OCEAN, UU, VV, WW, PP, TT, SS
from ...utils import logging as log


def average_block(An: torch.Tensor, landm: np.ndarray) -> np.ndarray:
    """Mean 6x6 center stencil block over OCEAN cells
    (average_block, scaling.F90:28-64), as a numpy (6, 6) array."""
    _, nun, _, l, m, n = An.shape
    ocean = (landm[1:l + 1, 1:m + 1, 1:n + 1] == OCEAN)
    nl = max(int(ocean.sum()), 1)
    mask = torch.as_tensor(ocean, dtype=An.dtype, device=An.device)
    db = (An[4] * mask).sum(dim=(2, 3, 4)) / nl
    return log.host(db).numpy()


def scal(db: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-variable row/col factors from the averaged diagonal block
    (scal, scaling.F90:192-280).  Returns (dr, dc), each (6,)."""
    dr = np.ones(6)
    dc = np.ones(6)
    try:
        mat = np.linalg.inv(db)
    except np.linalg.LinAlgError:
        return dr, dc                              # singular: no scaling
    idc = np.sqrt(abs(mat[UU, UU] / mat[VV, VV]))
    dr[VV] = 1.0 / idc
    dc[VV] = dr[VV]
    idr = np.sqrt(abs(mat[UU, UU] / mat[PP, PP]))
    dr[PP] = 1.0 / idr
    dc[PP] = dr[PP]
    # w: two possibilities
    if abs(mat[PP, WW]) > abs(mat[WW, WW]):
        idr_w = mat[UU, UU] / (idr * mat[PP, WW])
    else:
        idr_w = np.sqrt(abs(mat[UU, UU] / mat[WW, WW]))
    dr[WW] = 2.0 / idr_w
    dc[WW] = dr[WW]
    mat = mat.copy()
    for X in (TT, SS):
        if abs(mat[PP, X] * mat[X, PP]) < 0.01 * abs(mat[PP, PP]
                                                     * mat[X, X]):
            mat[PP, X] = 1.0
            mat[X, PP] = 1.0
        idc = np.sqrt(abs(mat[UU, UU] * mat[PP, X]
                          / (mat[X, PP] * mat[X, X])))
        dr[X] = 1.0 / (mat[UU, UU] / (idc * mat[X, X]))
        dc[X] = 1.0 / idc
    if not (np.isfinite(dr).all() and np.isfinite(dc).all()):
        return np.ones(6), np.ones(6)
    return dr, dc


def row_col_scaling(An: torch.Tensor, landm: np.ndarray
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Grid row/col scaling fields (6, l, m, n) — R = 1/dr, C = 1/dc on
    ocean cells, 1 on land, T and S averaged per cell — on An's device."""
    _, nun, _, l, m, n = An.shape
    dr, dc = scal(average_block(An, landm))
    ocean = (landm[1:l + 1, 1:m + 1, 1:n + 1] == OCEAN)
    R = np.where(ocean[None], (1.0 / dr)[:, None, None, None], 1.0)
    C = np.where(ocean[None], (1.0 / dc)[:, None, None, None], 1.0)
    for X in (R, C):
        mean = 0.5 * (X[TT] + X[SS])
        X[TT] = mean
        X[SS] = mean
    return (torch.as_tensor(R, dtype=An.dtype, device=An.device),
            torch.as_tensor(C, dtype=An.dtype, device=An.device))
