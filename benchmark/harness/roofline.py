"""Peaks and the work counts that a kernel's roofline share is read
against.

The counts come from what the inputs need, never from the layout a
kernel reads: any implementation of the product reads against the same
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def stencil_offsets() -> np.ndarray:
    """(27, 3) offsets (di, dj, dk) of the stencil tensor's first axis:
    p % 9 = 3 (di + 1) + (dj + 1), dk = 0, -1, +1 for p // 9 = 0, 1, 2."""
    return np.array([((p % 9) // 3 - 1, (p % 9) % 3 - 1, (0, -1, 1)[p // 9])
                     for p in range(27)])


def stencil_nonzeros(An: torch.Tensor, periodic: bool,
                     dtype=torch.float32) -> int:
    """Coefficients of the (27, 6, 6, l, m, n) stencil tensor An that are
    nonzero in dtype and whose neighbour lies in the grid (j and k never
    wrap; i wraps where periodic)."""
    _, _, _, l, m, n = An.shape
    k = torch.arange(l, device=An.device)[:, None, None]
    j = torch.arange(m, device=An.device)[None, :, None]
    i = torch.arange(n, device=An.device)[None, None, :]
    total = 0
    for p, (di, dj, dk) in enumerate(stencil_offsets()):
        inside = ((k + dk >= 0) & (k + dk < l) & (j + dj >= 0)
                  & (j + dj < m))
        if not periodic:
            inside = inside & (i + di >= 0) & (i + di < n)
        nz = An[p].to(dtype) != 0
        total += int((nz & inside[None, None]).sum())
    return total


def stencil_bytes(An: torch.Tensor, periodic: bool,
                  dtype=torch.float32) -> int:
    """Least bytes of one product y = An x in dtype: each needed nonzero
    coefficient read once, x read once and y written once."""
    item = torch.tensor([], dtype=dtype).element_size()
    nvec = An.shape[1] * An.shape[3] * An.shape[4] * An.shape[5]
    return (stencil_nonzeros(An, periodic, dtype) + 2 * nvec) * item
