"""Volume-transport diagnostics (PyTorch port of
``iemic_tpu/post/transports.py``; reference matlab/compute_transports.m):
integrate velocities across sections of the model grid.  The state is
read from the ocean's tensor on whatever device it lies, as numpy."""

from __future__ import annotations

import numpy as np


def _velocities(ocean):
    """(u, v) of the ocean's state as host arrays (l, m, n)."""
    g = ocean.grid
    x = ocean.get_state().detach().cpu().numpy().reshape(6, g.l, g.m, g.n)
    return x[0], x[1]


def compute_transports(ocean, i_section: int | None = None,
                       j_section: int | None = None):
    """Volume transport [Sv] through a meridional section i=i_section
    (zonal velocity u integrated over y,z) and/or a zonal section
    j=j_section (meridional velocity v integrated over x,z).

    Dimensionalization: u* = udim * u, dy* = r0dim * dy,
    dz* = hdim * dz (reference usr.F90 scales)."""
    g = ocean.grid
    u, v = _velocities(ocean)
    UDIM, R0DIM = 0.1, 6.37e6
    SV = 1e6
    ocean_mask = (ocean.landm[1:-1, 1:-1, 1:-1] == 0)

    dz = g.dz * g.dfzT * g.hdim                      # (l,)
    out = {}
    if i_section is not None:
        dy = g.dy * R0DIM
        upts = np.where(ocean_mask[:, :, i_section], u[:, :, i_section],
                        0.0)
        out["zonal"] = float(
            (upts * dz[:, None]).sum() * dy * UDIM / SV)
    if j_section is not None:
        cosy = np.cos(g.yv[1 + j_section])
        dx = g.dx * R0DIM * cosy
        vpts = np.where(ocean_mask[:, j_section, :], v[:, j_section, :],
                        0.0)
        out["meridional"] = float(
            (vpts * dz[:, None]).sum() * dx * UDIM / SV)
    return out


def build_path(coords: list[tuple[int, int]]) -> np.ndarray:
    """Staircase path between waypoints (the reference's getpath used
    by compute_transports.m:44-47 in mouse mode): returns an (N, 3)
    int array of (i, j, orientation) with orientation 1 = u-face
    (crossing in x) and 2 = v-face (crossing in y)."""
    segs = []
    for (i0, j0), (i1, j1) in zip(coords[:-1], coords[1:]):
        i, j = i0, j0
        while i != i1:
            step = 1 if i1 > i else -1
            segs.append((i if step > 0 else i - 1, j, 1))
            i += step
        while j != j1:
            step = 1 if j1 > j else -1
            segs.append((i, j if step > 0 else j - 1, 2))
            j += step
    return np.asarray(segs, dtype=np.int64)


def compute_path_transport(ocean, path: np.ndarray) -> float:
    """Volume transport [Sv] through an arbitrary staircase path
    (compute_transports.m:70-97 compute_transport): depth-integrated
    u through u-oriented faces times dy, v through v-oriented faces
    times dx*cos(y), summed along the path."""
    g = ocean.grid
    u, v = _velocities(ocean)
    UDIM, R0DIM, SV = 0.1, 6.37e6, 1e6
    dz = np.asarray(g.dz * g.dfzT * g.hdim)          # (l,)
    dy = g.dy * R0DIM
    total = 0.0
    for (i, j, orient) in np.asarray(path, dtype=np.int64):
        if orient == 1:
            col = (u[:, j, i] * dz).sum()
            total += col * dy
        else:
            dx = g.dx * R0DIM * float(np.cos(g.yv[1 + j]))
            col = (v[:, j, i] * dz).sum()
            total += col * dx
    return float(total * UDIM / SV)
