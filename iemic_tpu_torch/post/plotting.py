"""Field and diagram plotting (PyTorch port of
``iemic_tpu/post/plotting.py``; reference matlab/plot_ocean.m,
plot_overturning.m, plot_atmos.m, plot_seaice.m; scripts/plotbif.sh).

All functions accept a model instance (its state a tensor on any device)
or a file and return the matplotlib Figure so callers and tests can
inspect or save it.  matplotlib is imported inside the functions.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _ocean_xyz(ocean):
    g = ocean.grid
    rad2deg = 180.0 / np.pi
    return (g.x * rad2deg, g.y * rad2deg, g.z * g.hdim)


def plot_ocean(ocean, var: str = "T", k: int | None = None,
               fname: str | None = None):
    """Horizontal slice of one ocean field at level k (surface by
    default) — reference matlab/plot_ocean.m."""
    plt = _mpl()
    VARS = {"u": 0, "v": 1, "w": 2, "p": 3, "T": 4, "S": 5}
    x = _host(ocean.get_state()).reshape(
        6, ocean.grid.l, ocean.grid.m, ocean.grid.n)
    k = ocean.grid.l - 1 if k is None else k
    lon, lat, _ = _ocean_xyz(ocean)
    fld = x[VARS[var], k]
    land = ocean.landm[k + 1, 1:-1, 1:-1] != 0
    fld = np.where(land, np.nan, fld)
    fig, ax = plt.subplots(figsize=(7, 5))
    pc = ax.pcolormesh(lon, lat, fld, shading="nearest", cmap="RdBu_r")
    fig.colorbar(pc, ax=ax, label=var)
    ax.set_xlabel("longitude [deg]")
    ax.set_ylabel("latitude [deg]")
    ax.set_title(f"{var} at level {k}")
    if fname:
        fig.savefig(fname, dpi=120, bbox_inches="tight")
    return fig


def plot_overturning(ocean, fname: str | None = None):
    """Meridional overturning streamfunction psi_M(y, z)
    (matlab/plot_overturning.m)."""
    plt = _mpl()
    from ..models.ocean.diagnostics import psi_m
    psi = _host(psi_m(ocean.get_state(), ocean.grid, ocean.landm))
    fig, ax = plt.subplots(figsize=(7, 4))
    # psi is (l+1, m+1) on the (zw, yv) face grids
    yy = np.asarray(ocean.grid.yv) * 180.0 / np.pi
    zz = np.asarray(ocean.grid.zw) * ocean.grid.hdim
    pc = ax.contourf(yy, zz, psi, levels=21, cmap="RdBu_r")
    fig.colorbar(pc, ax=ax, label="psi_M")
    ax.set_xlabel("latitude [deg]")
    ax.set_ylabel("depth [m]")
    ax.set_title("meridional overturning streamfunction")
    if fname:
        fig.savefig(fname, dpi=120, bbox_inches="tight")
    return fig


def plot_barotropic(ocean, fname: str | None = None):
    """Barotropic streamfunction psi_B(x, y)."""
    plt = _mpl()
    from ..models.ocean.diagnostics import psi_b
    psi = _host(psi_b(ocean.get_state(), ocean.grid, ocean.landm))
    fig, ax = plt.subplots(figsize=(7, 5))
    # psi is (m+1, n+1) on the (yv, xu) corner grids
    lon = np.asarray(ocean.grid.xu) * 180.0 / np.pi
    lat = np.asarray(ocean.grid.yv) * 180.0 / np.pi
    pc = ax.contourf(lon, lat, psi, levels=21, cmap="RdBu_r")
    fig.colorbar(pc, ax=ax, label="psi_B")
    ax.set_xlabel("longitude [deg]")
    ax.set_ylabel("latitude [deg]")
    ax.set_title("barotropic streamfunction")
    if fname:
        fig.savefig(fname, dpi=120, bbox_inches="tight")
    return fig


def plot_atmosphere(atmos, var: str = "T", fname: str | None = None):
    """Atmosphere surface field (matlab/plot_atmos.m): T, q or albedo."""
    plt = _mpl()
    VARS = {"T": 0, "q": 1, "A": 2}
    n, m = atmos.n, atmos.m
    x = _host(atmos.get_state()).ravel()
    fld = x[:3 * n * m].reshape(m, n, 3)[:, :, VARS[var]]
    fig, ax = plt.subplots(figsize=(7, 5))
    pc = ax.pcolormesh(fld, shading="nearest", cmap="RdBu_r")
    fig.colorbar(pc, ax=ax, label=var)
    ax.set_title(f"atmosphere {var}")
    if fname:
        fig.savefig(fname, dpi=120, bbox_inches="tight")
    return fig


def plot_seaice(seaice, var: str = "H", fname: str | None = None):
    """Sea-ice field (matlab/plot_seaice.m): H, Qtsa, M or T."""
    plt = _mpl()
    VARS = {"H": 0, "Q": 1, "M": 2, "T": 3}
    n, m = seaice.n, seaice.m
    x = _host(seaice.get_state()).ravel()
    fld = x[:4 * n * m].reshape(m, n, 4)[:, :, VARS[var]]
    fig, ax = plt.subplots(figsize=(7, 5))
    pc = ax.pcolormesh(fld, shading="nearest", cmap="viridis")
    fig.colorbar(pc, ax=ax, label=var)
    ax.set_title(f"sea ice {var}")
    if fname:
        fig.savefig(fname, dpi=120, bbox_inches="tight")
    return fig


def read_cdata(path: str = "cdata.txt"):
    """Parse the continuation data table written by
    Continuation.write_data (columns par, ds, ||x||, ||F||, NR, MV,
    max psi, min psi — reference Continuation.H:1276-1319)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            try:
                rows.append([float(v) for v in parts])
            except ValueError:
                continue
    return np.asarray(rows)


def plot_bif(path: str = "cdata.txt", ycol: int = 6,
             fname: str | None = None):
    """Bifurcation diagram from cdata.txt (scripts/plotbif.sh): the
    continuation parameter against max(psi) by default."""
    plt = _mpl()
    dat = read_cdata(path)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(dat[:, 0], dat[:, ycol], ".-")
    ax.set_xlabel("continuation parameter")
    ax.set_ylabel(f"column {ycol} (max psi)")
    ax.set_title("bifurcation diagram")
    if fname:
        fig.savefig(fname, dpi=120, bbox_inches="tight")
    return fig
