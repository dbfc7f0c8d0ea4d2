"""Vertical column-block preconditioner and pressure null modes (PyTorch).

Port of ``iemic_tpu/solvers/preconditioner.py``: each water column
(i, j) couples its nv*l unknowns through the stencil's center-column
locations (5, 14, 23); those dense blocks are inverted in one batched
``torch.linalg.inv_ex`` and applied as block Jacobi (De Niet & Wubs,
reference TRIOS_BlockPreconditioner.H:36-100).  The pressure null modes
(THCM::getNullSpace, THCM.C:2846-2888) are candidates for deflation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.stencil import PP, OCEAN


def inv(B: torch.Tensor) -> torch.Tensor:
    """Batched inverse; singular blocks give inf/nan like LAPACK rather
    than raising (callers gauge dummy rows to identity first)."""
    return torch.linalg.inv_ex(B)[0]


def column_blocks(diag: torch.Tensor, down: torch.Tensor,
                  up: torch.Tensor) -> torch.Tensor:
    """Per-column block-tridiagonal matrices from the center-column
    stencil planes diag/down/up (nv, nv, l, m, n) -> (m*n, l*nv, l*nv),
    unknowns in (k, var) order."""
    nv, _, l, m, n = diag.shape
    B = diag.new_zeros((m, n, l, nv, l, nv))
    dg = diag.permute(2, 3, 4, 0, 1)          # (l, m, n, nv, nv)
    dn = down.permute(2, 3, 4, 0, 1)
    upt = up.permute(2, 3, 4, 0, 1)
    for k in range(l):
        B[:, :, k, :, k, :] = dg[k]
        if k > 0:
            B[:, :, k, :, k - 1, :] = dn[k]
        if k < l - 1:
            B[:, :, k, :, k + 1, :] = upt[k]
    return B.reshape(m * n, l * nv, l * nv)


def to_columns(r: torch.Tensor) -> torch.Tensor:
    """(nv, l, m, n) -> (m*n, l*nv) in (k, var) order."""
    nv, l, m, n = r.shape
    return r.permute(2, 3, 1, 0).reshape(m * n, l * nv)


def from_columns(zc: torch.Tensor, nv: int, l: int, m: int, n: int
                 ) -> torch.Tensor:
    """Inverse of :func:`to_columns`."""
    return zc.reshape(m, n, l, nv).permute(3, 2, 0, 1)


def apply_col_inv(binv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Apply batched column-block inverses: r (nv, l, m, n) -> z."""
    nv, l, m, n = r.shape
    zc = torch.bmm(binv, to_columns(r).unsqueeze(-1)).squeeze(-1)
    return from_columns(zc, nv, l, m, n)


def build_column_blocks(An: torch.Tensor, *, eps: float = 1e-8
                        ) -> torch.Tensor:
    """Batched inverses of the full (6l x 6l) vertical column blocks.

    Every water column's block is singular along the column-constant
    pressure; that mode gets a rank-one shift of the block's own scale
    (keeping the factors O(1/physics) for the f32 copy) plus eps*I."""
    _, nun, _, l, m, n = An.shape
    d = nun * l
    B = column_blocks(An[4], An[13], An[22])
    e = An.new_zeros(d)
    e[PP::nun] = 1.0 / np.sqrt(float(l))
    scale = torch.amax(torch.abs(B), dim=(1, 2), keepdim=True)
    B = B + torch.clamp(scale, min=1.0) * e[:, None] * e[None, :]
    B = B + eps * torch.eye(d, dtype=An.dtype, device=An.device)
    return inv(B)


def apply_column_prec(Binv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Apply the column-block preconditioner: r (6, l, m, n) -> z."""
    return apply_col_inv(Binv, r)


def pressure_null_vectors(landm: np.ndarray, l: int, m: int, n: int,
                          *, periodic: bool = False) -> list[np.ndarray]:
    """Candidate pressure null modes (constant + checkerboard per
    connected wet component, periodic seam merged), field layout
    (6, l, m, n), normalized, numpy.  Validity against the operator is
    checked by the caller."""
    ocean = (landm[1:l + 1, 1:m + 1, 1:n + 1] == OCEAN)
    from scipy import ndimage
    lab, nlab = ndimage.label(ocean)
    if periodic and n > 1 and nlab > 1:
        parent = list(range(nlab + 1))

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        seam = ocean[:, :, 0] & ocean[:, :, -1]
        for a, b in zip(lab[:, :, 0][seam], lab[:, :, -1][seam]):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[rb] = ra
        lab = np.vectorize(lambda v: find(int(v)) if v else 0)(lab)

    ij = (np.arange(m)[:, None] + np.arange(n)[None, :]) % 2
    cbpat = np.where(ij == 0, 1.0, -1.0)
    out = []
    for c in np.unique(lab):
        if c == 0:
            continue
        comp = lab == c
        for pat in (1.0, cbpat):
            v = np.zeros((6, l, m, n))
            v[PP] = np.where(comp, pat, 0.0)
            out.append(v / max(np.linalg.norm(v), 1e-300))
    return out
