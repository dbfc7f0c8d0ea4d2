# Copied from iemic_tpu/models/ocean/forcing_data.py (numpy-only; importing iemic_tpu would import jax).
"""Data-based forcing: Levitus climatology readers + monthly cycles.

TPU-native replacement of the reference's Levitus/monthly forcing
machinery (reference src/ocean/levitus.F90:3-210, monthly.F90:22-287,
lev.F90:1-14).  All file IO and grid interpolation happen host-side in
numpy at setup; the produced fields are handed to the jitted forcing
assembly (assembly.forcing's ``ForcingFields``) as device arrays.

The Levitus-94 file format: plain ASCII, one 360x180 longitude-latitude
field per depth level, Fortran format ``(10f8.4)``, missing value
-99.9999 (levitus.F90:140-152).  Interpolation to the model grid is the
reference's box-average: all data points inside a model cell are
averaged, and the box is widened until at least one valid point is
found (levitus.F90:163-205 with `interpol`'s widening loop).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: Levitus standard depths [m] (reference lev.F90:7)
LEV_DEPTH = np.array([0, 10, 20, 30, 50, 75, 100, 125, 150, 200, 250,
                      300, 400, 500, 600, 700, 800, 900, 1000, 1100,
                      1200, 1300, 1400, 1500, 1750, 2000, 2500, 3000,
                      3500, 4000, 4500, 5000, 5500], dtype=np.float64)
NLEV = 33
NLEV_MONTHLY = 24        # monthly files only reach 1500 m (lev.F90:4)
MISSING = -99.9999

#: reference nondimensionalization constants (usr.F90 / m_par)
T0 = 15.0
S0 = 35.0


def read_levitus_file(path: str, nlayers: int) -> np.ndarray:
    """Read a Levitus-94 ASCII file: ``nlayers`` stacked 360x180 fields
    in '(10f8.4)' rows (levitus.F90:148-151).  Returns
    (nlayers, 180, 360) with np.nan for missing."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            for i in range(0, len(line), 8):
                s = line[i:i + 8].strip()
                if s:
                    vals.append(float(s))
    need = nlayers * 360 * 180
    if len(vals) < need:
        nlayers = len(vals) // (360 * 180)
        need = nlayers * 360 * 180
    dat = np.asarray(vals[:need]).reshape(nlayers, 180, 360)
    dat[dat <= MISSING + 10.0] = np.nan
    return dat


def levitus_interpol(dat: np.ndarray, grid, landm: np.ndarray, k: int,
                     lolimit: float, uplimit: float) -> np.ndarray:
    """Box-average one (180, 360) Levitus layer onto model level k.

    Mirrors levitus_interpol (levitus.F90:123-210): clip to
    [lolimit, uplimit], average all valid data points whose 1-degree
    index falls in the model cell, widen the box on total miss."""
    n, m = grid.n, grid.m
    dat = np.clip(dat, lolimit, uplimit)
    # periodic in longitude: index 0 == index 360 (levitus.F90:160)
    ext = np.concatenate([dat[:, -1:], dat], axis=1)   # (180, 361)
    out = np.full((m, n), np.nan)
    rad2deg = 180.0 / np.pi
    for j in range(m):
        yjlow = rad2deg * (grid.y[j] - 0.5 * grid.dy)
        yjhigh = rad2deg * (grid.y[j] + 0.5 * grid.dy)
        jjlow = int(np.ceil(yjlow + 90.5))
        jjhigh = int(np.floor(yjhigh + 90.5))
        for i in range(n):
            if landm[k + 1, j + 1, i + 1] != 0:      # not OCEAN
                continue
            xilow = rad2deg * (grid.x[i] - 0.5 * grid.dx)
            xihigh = rad2deg * (grid.x[i] + 0.5 * grid.dx)
            iilow = max(int(np.ceil(xilow)), 0)
            iihigh = min(int(np.floor(xihigh)), 360)
            jl, jh, il, ih = jjlow, jjhigh, iilow, iihigh
            for _ in range(10):
                jl_c, jh_c = max(jl, 1), min(jh, 180)
                box = ext[jl_c - 1:jh_c, il:ih + 1]
                good = np.isfinite(box)
                if good.any():
                    out[j, i] = box[good].mean()
                    break
                il, ih, jl, jh = max(il - 1, 0), min(ih + 1, 360), \
                    jl - 1, jh + 1
            else:
                raise RuntimeError(
                    f"definite levitus miss at k={k} i={i} j={j}")
    return np.nan_to_num(out, nan=MISSING / 20.0)


def levitus_internal(path: str, grid, landm: np.ndarray, kind: str,
                     monthly: bool = False) -> np.ndarray:
    """3D internal T or S climatology on the model grid
    (levitus_internal, levitus.F90:3-49): for each model level pick the
    deepest Levitus level at or above the model depth, interpolate
    horizontally, subtract the reference value T0/S0."""
    nlayers = NLEV_MONTHLY if monthly else NLEV
    dat = read_levitus_file(path, nlayers)
    nlayers = dat.shape[0]
    l = grid.l
    out = np.zeros((l, grid.m, grid.n))
    ref = {"TEMP": T0, "SALT": S0}[kind]
    lo, up = (-5.0, 50.0) if kind == "TEMP" else (0.0, 50.0)
    for k in range(l):
        dep = -grid.z[k] * grid.hdim
        klev = int(np.searchsorted(LEV_DEPTH[:nlayers], dep,
                                   side="right")) - 1
        klev = max(0, min(klev, nlayers - 1))
        out[k] = levitus_interpol(dat[klev], grid, landm, k, lo, up) - ref
    return out


def levitus_surface(path: str, grid, landm: np.ndarray,
                    kind: str) -> np.ndarray:
    """Surface (level 0) climatology for SST/SSS restoring
    (levitus_sst / levitus_sal, levitus.F90:52-121)."""
    dat = read_levitus_file(path, 1)
    ref = {"TEMP": T0, "SALT": S0}[kind]
    lo, up = (-5.0, 50.0) if kind == "TEMP" else (0.0, 50.0)
    return levitus_interpol(dat[0], grid, landm, grid.l - 1, lo, up) - ref


# ---------------------------------------------------------------------
# Monthly (seasonal) forcing
# ---------------------------------------------------------------------

#: nondimensional time scale factors (monthly.F90:253-263):
#: time is in units of r0dim/udim seconds
R0DIM = 6.37e6
UDIM = 0.1
SECS_PER_YEAR = 3600.0 * 24.0 * 365.0
SECS_PER_MONTH = SECS_PER_YEAR / 12.0


def split_time(time: float, nt: int = 12):
    """Nondimensional time -> (year, months[4], weights[4]) with
    piecewise-linear interpolation (split_time, monthly.F90:238-287).
    Returned month indices are 0-based; -1 marks unused slots."""
    t_secs = time * (R0DIM / UDIM)
    year = int(t_secs / SECS_PER_YEAR)
    this_month = int((t_secs - year * SECS_PER_YEAR) / SECS_PER_MONTH)
    this_month = min(this_month, nt - 1)
    months = [-1, -1, -1, -1]
    weights = [0.0, 0.0, 0.0, 0.0]
    months[0] = this_month
    months[1] = (this_month + 1) % nt
    # weight(1) = (t - (year*spy + (m+1)*spm)) / (-spm)  [1-based m]
    w1 = (t_secs - (year * SECS_PER_YEAR
                    + (this_month + 1) * SECS_PER_MONTH)) / (-SECS_PER_MONTH)
    weights[0] = w1
    weights[1] = 1.0 - w1
    return year, months, weights


@dataclass
class MonthlyForcing:
    """Annual-mean + 12 monthly surface forcing fields with seasonal
    interpolation (m_monthly, monthly.F90:22-226).

    gammaW/T/S in [0,1] blend annual (gamma=0) vs seasonal cycle
    (gamma=1), exactly the reference's update_forcing contract."""
    ataux: np.ndarray            # annual (m, n)
    atauy: np.ndarray
    atatm: np.ndarray
    aemip: np.ndarray
    mtaux: np.ndarray | None = None   # monthly (12, m, n)
    mtauy: np.ndarray | None = None
    mtatm: np.ndarray | None = None
    memip: np.ndarray | None = None
    # internal 3D fields (12, l, m, n) for Levitus Internal T/S mode
    mtemp: np.ndarray | None = None
    msalt: np.ndarray | None = None
    atemp: np.ndarray | None = None
    asalt: np.ndarray | None = None
    nt: int = 12

    def update(self, t: float, gammaW: float, gammaT: float,
               gammaS: float):
        """Surface fields at nondimensional time t
        (update_forcing, monthly.F90:133-188).  Returns
        (taux, tauy, tatm, emip)."""
        taux = (1.0 - gammaW) * self.ataux
        tauy = (1.0 - gammaW) * self.atauy
        tatm = (1.0 - gammaT) * self.atatm
        emip = (1.0 - gammaS) * self.aemip
        _, months, weights = split_time(t, self.nt)
        for mo, w in zip(months, weights):
            if mo < 0 or w == 0.0:
                continue
            if self.mtaux is not None:
                taux = taux + gammaW * w * self.mtaux[mo]
                tauy = tauy + gammaW * w * self.mtauy[mo]
            if self.mtatm is not None:
                tatm = tatm + gammaT * w * self.mtatm[mo]
            if self.memip is not None:
                emip = emip + gammaS * w * self.memip[mo]
        return taux, tauy, tatm, emip

    def update_internal(self, t: float, gammaT: float, gammaS: float):
        """Internal 3D T/S fields at time t
        (update_internal_forcing, monthly.F90:190-226)."""
        temp = (1.0 - gammaT) * self.atemp if self.atemp is not None \
            else None
        salt = (1.0 - gammaS) * self.asalt if self.asalt is not None \
            else None
        _, months, weights = split_time(t, self.nt)
        for mo, w in zip(months, weights):
            if mo < 0 or w == 0.0:
                continue
            if self.mtemp is not None and temp is not None:
                temp = temp + gammaT * w * self.mtemp[mo]
            if self.msalt is not None and salt is not None:
                salt = salt + gammaS * w * self.msalt[mo]
        return temp, salt


# ---------------------------------------------------------------------
# Wind-stress data (Trenberth-style files)
# ---------------------------------------------------------------------

def read_wind_file(path: str):
    """Read a Trenberth-format wind-stress file
    (windfit, reference src/ocean/forcing.F90:268-355): one header
    line, nx=145 longitudes, ny=72 latitudes (degrees), then nx*ny
    (taux, tauy) pairs in x-major order.  Returns
    (lon_deg (nx,), lat_deg (ny,), taux (ny, nx), tauy (ny, nx))."""
    with open(path) as f:
        tokens = f.read().split("\n")
    # skip header line, then parse whitespace-separated floats
    vals = []
    for line in tokens[1:]:
        vals.extend(float(v) for v in line.split())
    nx, ny = 145, 72
    xx = np.asarray(vals[:nx])
    yy = np.asarray(vals[nx:nx + ny])
    rest = np.asarray(vals[nx + ny:nx + ny + 2 * nx * ny])
    pairs = rest.reshape(nx, ny, 2)
    taux = pairs[:, :, 0].T       # (ny, nx)
    tauy = pairs[:, :, 1].T
    return xx, yy, taux, tauy


def windfit(path: str, grid):
    """Bilinear fit of the wind data onto the model (xu, yv) grid
    (windfit's itplbv path).  Returns taux, tauy of shape (m, n)."""
    from scipy.interpolate import RegularGridInterpolator
    xx, yy, tx, ty = read_wind_file(path)
    rad2deg = 180.0 / np.pi
    xi = grid.xu[1:] * rad2deg          # u points
    yi = grid.yv[1:] * rad2deg          # v points
    fx = RegularGridInterpolator((yy, xx), tx, bounds_error=False,
                                 fill_value=None)
    fy = RegularGridInterpolator((yy, xx), ty, bounds_error=False,
                                 fill_value=None)
    Y, X = np.meshgrid(yi, xi, indexing="ij")
    pts = np.stack([Y.ravel(), X.ravel()], axis=1)
    return fx(pts).reshape(grid.m, grid.n), \
        fy(pts).reshape(grid.m, grid.n)
