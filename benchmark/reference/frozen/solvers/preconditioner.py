"""Pressure null modes of the ocean's stencil tensor (THCM::getNullSpace,
THCM.C:2846-2888): candidates for the solve's deflation.
"""

from __future__ import annotations

import numpy as np

from ..ops.stencil import PP, OCEAN


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
