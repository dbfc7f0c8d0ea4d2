# Copied from iemic_tpu/grid.py (numpy-only; importing iemic_tpu would import jax).
"""Arakawa B/C staggered lat-lon-z grid with stretched vertical coordinate.

Re-implements the reference's grid setup (reference src/ocean/grid.F90:2-95
``grid``, ``fz``, ``dfdz`` and array conventions of src/ocean/usr.F90:192):

  * cell centers  x(1:n), y(0:m+1), z(1:l)
  * cell faces    xu(0:n), yv(0:m), zw(0:l)
  * vertical stretching z = fz(ze, qz) with metric derivatives dfzT (at
    T points) and dfzW (at w points).

Arrays are stored 0-based with the same *logical* extents as the Fortran
arrays; ``y`` has ghost entries at both ends (y[0] and y[m+1] in Fortran
indexing map to ``y_ext[0]`` and ``y_ext[m+1]`` here).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def fz(z: np.ndarray, qz: float) -> np.ndarray:
    """Vertical stretching map (reference grid.F90:62-78)."""
    if qz > 1.0:
        return -1.0 + np.tanh(qz * (z + 1.0)) / np.tanh(qz)
    return z + (1.0 - qz) * z * (1.0 - z)


def dfdz(z: np.ndarray, qz: float) -> np.ndarray:
    """Derivative of the stretching map (reference grid.F90:80-95)."""
    if qz > 1.0:
        ch = np.cosh(qz * (z + 1.0))
        return qz / (np.tanh(qz) * ch * ch)
    return 1.0 + (1.0 - qz) * (1.0 - 2.0 * z)


@dataclass(frozen=True)
class Grid:
    """Static grid geometry for one (sub)domain.

    All angle quantities are in radians; vertical coordinates are
    nondimensional in [zmin, zmax] = [-1, 0], dimensionalized by hdim.
    """

    n: int                 # east-west (x)
    m: int                 # north-south (y)
    l: int                 # vertical (z)
    periodic: bool
    xmin: float
    xmax: float
    ymin: float
    ymax: float
    hdim: float            # ocean depth [m]
    qz: float              # stretching parameter

    dx: float
    dy: float
    dz: float
    x: np.ndarray          # (n,)   cell centers
    xu: np.ndarray         # (n+1,) = Fortran xu(0:n)
    y_ext: np.ndarray      # (m+2,) = Fortran y(0:m+1), centers + ghosts
    yv: np.ndarray         # (m+1,) = Fortran yv(0:m)
    z: np.ndarray          # (l,)   stretched centers
    zw: np.ndarray         # (l+1,) = Fortran zw(0:l), stretched faces
    ze: np.ndarray         # (l,)   equidistant centers
    zwe: np.ndarray        # (l,)   equidistant faces (1..l)
    dfzT: np.ndarray       # (l,)   metric derivative at T points
    dfzW: np.ndarray       # (l+1,) = Fortran dfzW(0:l)

    zmin: float = -1.0
    zmax: float = 0.0

    @property
    def y(self) -> np.ndarray:
        """Interior cell-center latitudes, Fortran y(1:m)."""
        return self.y_ext[1:-1]

    @property
    def ndim(self) -> int:
        return 6 * self.n * self.m * self.l


def make_grid(n: int, m: int, l: int, *,
              xmin_deg: float, xmax_deg: float,
              ymin_deg: float, ymax_deg: float,
              hdim: float = 4000.0, qz: float = 1.0,
              periodic: bool = False) -> Grid:
    """Build a Grid; bounds given in degrees as in the XML configs
    (reference src/ocean/THCM.C:202-205 converts with pi/180)."""
    xmin = np.deg2rad(xmin_deg)
    xmax = np.deg2rad(xmax_deg)
    ymin = np.deg2rad(ymin_deg)
    ymax = np.deg2rad(ymax_deg)
    zmin, zmax = -1.0, 0.0

    dx = (xmax - xmin) / n
    dy = (ymax - ymin) / m
    dz = (zmax - zmin) / l

    i = np.arange(1, n + 1, dtype=np.float64)
    x = (i - 0.5) * dx + xmin
    xu = np.concatenate([[xmin], i * dx + xmin])       # xu(0:n)

    j = np.arange(1, m + 1, dtype=np.float64)
    y = (j - 0.5) * dy + ymin
    y_ext = np.concatenate([[y[0] - dy], y, [y[-1] + dy]])
    yv = np.concatenate([[ymin], j * dy + ymin])       # yv(0:m)

    k = np.arange(1, l + 1, dtype=np.float64)
    ze = (k - 0.5) * dz + zmin
    zwe = k * dz + zmin
    z = fz(ze, qz)
    zw = np.concatenate([[zmin], fz(zwe, qz)])         # zw(0:l)
    dfzT = dfdz(ze, qz)
    dfzW = np.concatenate([[float(dfdz(np.asarray(zmin), qz))],
                           dfdz(zwe, qz)])             # dfzW(0:l)

    return Grid(n=n, m=m, l=l, periodic=periodic,
                xmin=float(xmin), xmax=float(xmax),
                ymin=float(ymin), ymax=float(ymax),
                hdim=hdim, qz=qz,
                dx=float(dx), dy=float(dy), dz=float(dz),
                x=x, xu=xu, y_ext=y_ext, yv=yv,
                z=z, zw=zw, ze=ze, zwe=zwe, dfzT=dfzT, dfzW=dfzW)
