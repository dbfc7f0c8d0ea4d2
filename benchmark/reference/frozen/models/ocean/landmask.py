# Copied from iemic_tpu/models/ocean/landmask.py (numpy-only; importing iemic_tpu would import jax).
"""Land-mask construction and mask-file I/O.

Re-implements the reference's mask handling: mkmask file reading
(src/ocean/topo.F90:41-140 ``readmask``), dummy-layer setup and the
land-inversion fix (src/ocean/usrc.F90:79-107, 372-391), the salinity
perturbation mask reader (src/ocean/forcing.F90:457-486), and the
idealized no-land topography (itopo == 1).

Mask array layout: (l+2, m+2, n+2) int, [k, j, i], values
OCEAN/LAND/WATER/PERIO (par.F90:77-81).
"""

from __future__ import annotations

import numpy as np

from ...grid import Grid
from ...ops.stencil import OCEAN, LAND, WATER, PERIO


def no_land(grid: Grid) -> np.ndarray:
    """itopo == 1: all-ocean interior."""
    l, m, n = grid.l, grid.m, grid.n
    landm = np.full((l + 2, m + 2, n + 2), LAND, dtype=np.int32)
    landm[1:l + 1, 1:m + 1, 1:n + 1] = OCEAN
    return landm


def read_mask_file(path: str, grid: Grid) -> np.ndarray:
    """Read a mkmask-format land mask: per level k = 0..l+1 a header
    line then m+2 digit rows from j = m+1 down to 0 (topo.F90:41-66)."""
    l, m, n = grid.l, grid.m, grid.n
    landm = np.full((l + 2, m + 2, n + 2), LAND, dtype=np.int32)
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    pos = 0
    for k in range(l + 2):
        pos += 1  # header line
        for j in range(m + 1, -1, -1):
            row = lines[pos]
            pos += 1
            digits = [int(ch) for ch in row.strip()[:n + 2]]
            landm[k, j, :len(digits)] = digits
    return landm


def finalize_mask(landm: np.ndarray, grid: Grid, periodic: bool,
                  flat: bool = False,
                  file_ghosts: bool = False) -> np.ndarray:
    """Dummy layers, periodic ring, land-inversion fix and optional
    flat bottom, mirroring usrc.F90 init/set_landmask.

    file_ghosts=True preserves the x-ghost columns as read from a
    mkmask file: for periodic domains those columns DEFINE where the
    seam is open (PERIO) vs walled (LAND) — e.g. mask_gateway opens
    only two latitude rows.  Open (PERIO) ghosts are replaced by the
    wrapped interior content so every ==OCEAN/==LAND comparison and the
    mixing isoc masks behave like the Fortran's PERIO cells; walled
    (LAND) ghosts stay LAND, and boundaries() then applies the wall
    treatment at those seam rows exactly as at an interior coastline.
    """
    landm = landm.copy()
    l, m, n = grid.l, grid.m, grid.n

    if flat:  # remove bottom topography (topo.F90:107-111)
        for k in range(1, l):
            landm[k, :, :] = landm[l, :, :]

    # land inversion fix (usrc.F90:372-381)
    for k in range(l, 1, -1):
        inv = (landm[k, 1:m + 1, 1:n + 1] == LAND) \
            & (landm[k - 1, 1:m + 1, 1:n + 1] == OCEAN)
        landm[k - 1, 1:m + 1, 1:n + 1] = np.where(
            inv, LAND, landm[k - 1, 1:m + 1, 1:n + 1])

    # dummy layers (usrc.F90:100-107)
    if periodic and file_ghosts:
        open_w = landm[:, :, 0] != LAND
        open_e = landm[:, :, n + 1] != LAND
        landm[:, :, 0] = np.where(open_w, landm[:, :, n], LAND)
        landm[:, :, n + 1] = np.where(open_e, landm[:, :, 1], LAND)
        landm[:, :, 0][landm[:, :, 0] == PERIO] = OCEAN
        landm[:, :, n + 1][landm[:, :, n + 1] == PERIO] = OCEAN
    elif periodic:
        # generated masks: seam open wherever both ends are ocean
        # (topofit, topo.F90:314-318); the ring carries wrap values
        # (PERIO markers behave as ocean in ==LAND / ==OCEAN checks)
        landm[:, :, 0] = landm[:, :, n]
        landm[:, :, n + 1] = landm[:, :, 1]
        landm[:, :, 0][landm[:, :, 0] == PERIO] = OCEAN
        landm[:, :, n + 1][landm[:, :, n + 1] == PERIO] = OCEAN
    else:
        landm[:, :, 0] = LAND
        landm[:, :, n + 1] = LAND
    landm[:, 0, :] = LAND
    landm[:, m + 1, :] = LAND
    landm[0, :, :] = LAND
    landm[l + 1, :, :] = LAND
    return landm


def read_spert_mask(path: str, grid: Grid, landm: np.ndarray) -> np.ndarray:
    """Salinity perturbation mask (forcing.F90:457-486): rows j = m+1..0
    of n+2 digits; spert(i,j) = (1 - dum(i,j)) * (1 - landm(i,j,l))."""
    l, m, n = grid.l, grid.m, grid.n
    dum = np.zeros((m + 2, n + 2), dtype=np.int32)
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    for idx, j in enumerate(range(m + 1, -1, -1)):
        digits = [int(ch) for ch in lines[idx].strip()[:n + 2]]
        dum[j, :len(digits)] = digits
    surf = 1.0 - landm[l, 1:m + 1, 1:n + 1].astype(np.float64)
    return (1.0 - dum[1:m + 1, 1:n + 1]) * surf


def flood_fill3d(landm: np.ndarray, seed: tuple[int, int, int],
                 old: int, new: int) -> np.ndarray:
    """Iterative 6-neighbor flood fill on the padded mask
    (topo.F90:339-353 ``flood`` — recursion replaced by a worklist)."""
    landm = landm.copy()
    k0, j0, i0 = seed
    if landm[k0, j0, i0] != old:
        return landm
    stack = [(k0, j0, i0)]
    landm[k0, j0, i0] = new
    L, M, N = landm.shape
    while stack:
        k, j, i = stack.pop()
        for dk, dj, di in ((1, 0, 0), (-1, 0, 0), (0, 1, 0),
                           (0, -1, 0), (0, 0, 1), (0, 0, -1)):
            kk, jj, ii = k + dk, j + dj, i + di
            if 0 <= kk < L and 0 <= jj < M and 0 <= ii < N \
                    and landm[kk, jj, ii] == old:
                landm[kk, jj, ii] = new
                stack.append((kk, jj, ii))
    return landm


def fillbays(landm: np.ndarray, grid: Grid, max_iter: int = 15,
             open_value: int = OCEAN) -> np.ndarray:
    """Morphological bay removal (topo.F90:356-399): land any cell with
    >= 3 lateral land neighbors, open any with <= 1, and land surface
    cells above subsurface land, iterated to a fixed point.  Inside the
    depth3land pipeline the open value is WATER so the subsequent
    connected-ocean flood fill still distinguishes unvisited water."""
    landm = landm.copy()
    l, m, n = grid.l, grid.m, grid.n
    for _ in range(max_iter):
        old = landm.copy()
        intr = landm[1:l + 1, 1:m + 1, 1:n + 1]
        nland = ((landm[1:l + 1, 1:m + 1, 2:n + 2] == LAND).astype(int)
                 + (landm[1:l + 1, 1:m + 1, 0:n] == LAND)
                 + (landm[1:l + 1, 2:m + 2, 1:n + 1] == LAND)
                 + (landm[1:l + 1, 0:m, 1:n + 1] == LAND))
        intr = np.where(nland >= 3, LAND,
                        np.where(nland <= 1, open_value, intr))
        landm[1:l + 1, 1:m + 1, 1:n + 1] = intr
        # surface above land is land
        below_land = landm[l - 1, 1:m + 1, 1:n + 1] == LAND
        landm[l, 1:m + 1, 1:n + 1] = np.where(
            below_land, LAND, landm[l, 1:m + 1, 1:n + 1])
        if np.array_equal(landm, old):
            break
    return landm


def depth_to_land(depth2d: np.ndarray, grid: Grid) -> np.ndarray:
    """Bathymetry (m, n) in meters (positive down is NOT assumed: pass
    the sea-floor z-coordinate, negative below sea level) -> raw padded
    landmask via the reference's depth3land pipeline
    (topo.F90:136-177, itopo==0): mark WATER where the cell center lies
    above the floor, remove bays, flood-fill the connected ocean from a
    surface seed, and land every disconnected WATER pocket."""
    l, m, n = grid.l, grid.m, grid.n
    d = np.asarray(depth2d, float) / grid.hdim
    landm = np.full((l + 2, m + 2, n + 2), LAND, dtype=np.int32)
    for k in range(l):
        landm[k + 1, 1:m + 1, 1:n + 1] = np.where(
            grid.z[k] > d, WATER, LAND)
    landm = fillbays(landm, grid, open_value=WATER)
    # surface seed: walk east from the domain center (topo.F90:162-168)
    j = m // 2 + 1
    k = l
    i = n // 2 + 1
    while landm[k, j, i] != WATER:
        i += 1
        if i > n:
            raise RuntimeError("depth3land: cannot find ocean point")
    landm = flood_fill3d(landm, (k, j, i), WATER, OCEAN)
    landm[landm == WATER] = LAND
    return landm


def miocene(grid: Grid) -> np.ndarray:
    """Idealized Miocene continents (topo.F90 itopo==2:186-262):
    rectangular South America / South Africa / North America / Asia
    blocks on an all-ocean domain."""
    l, m, n = grid.l, grid.m, grid.n
    landm = np.full((l + 2, m + 2, n + 2), LAND, dtype=np.int32)
    landm[1:l + 1, 1:m + 1, 1:n + 1] = OCEAN
    d = np.pi / 180.0
    ph1, ph2, ph3, ph4 = 250 * d, 315 * d, 10 * d, 65 * d
    thd, thsa, thn, tha = -60 * d, -35 * d, 10 * d, 30 * d
    x, y = grid.x, grid.y
    for i in range(n):
        for j in range(m):
            land = False
            if ph1 < x[i] < ph2 and thd < y[j] < 0.0:
                land = True                     # south america
            if ph3 < x[i] < ph4 and thsa < y[j] < thn:
                land = True                     # south africa
            if ph1 < x[i] < ph2 and tha < y[j] < grid.ymax:
                land = True                     # north america
            if ph3 < x[i] < ph4 and tha < y[j] < grid.ymax:
                land = True                     # asia
            if land:
                landm[1:l + 1, j + 1, i + 1] = LAND
    return landm
