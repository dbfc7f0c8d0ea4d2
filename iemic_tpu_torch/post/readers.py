# Copied from iemic_tpu/post/readers.py (numpy-only; importing iemic_tpu would import jax).
"""General HDF5 reader suite — the readhdf5.m analog.

The reference's MATLAB toolbox reads every I-EMIC HDF5 artifact through
one dispatcher (reference matlab/readhdf5.m: states, eigenvector files,
flux fields) plus plot_* helpers that reshape the flat state into
(n, m, l, nun) grids.  Here:

  * :func:`read_state`      — state + parameters + extra field groups
  * :func:`read_eigen`      — ev_step_<n>.h5 eigenpair files
  * :func:`read_cdata`      — the cdata.txt continuation table
  * :func:`read_tdata`      — the tdata.txt transient table
  * :func:`state_to_grid`   — flat state -> per-variable (l, m, n) dict
  * :func:`read_profile`    — the profile_output timing table
"""

from __future__ import annotations

import re

import numpy as np

#: ocean variable order (par.F90:71-77)
OCEAN_VARS = ("u", "v", "w", "p", "T", "S")
ATMOS_VARS = ("Ta", "qa", "alpha")
SEAICE_VARS = ("H", "Qtsa", "M", "Tsi")


def read_state(filename: str) -> dict:
    """Read a checkpoint written by utils.hdf5.save_state (or the
    reference's EpetraExt HDF5 layout, Model.H:254-310): returns
    {"state": flat array, "parameters": {name: value}, "fields":
    {group: array}} with every non-State/Parameters group exposed as an
    extra field (fluxes, etc. — the additionalExports analog)."""
    import h5py
    out = {"state": None, "parameters": {}, "fields": {}}
    with h5py.File(filename, "r") as f:
        if "State" in f:
            out["state"] = np.asarray(f["State/Values"])
        if "Parameters" in f:
            for name in f["Parameters"]:
                val = np.asarray(f["Parameters"][name])
                out["parameters"][name] = (float(val) if val.size == 1
                                           else val)
        for grp in f:
            if grp in ("State", "Parameters"):
                continue
            node = f[grp]
            if hasattr(node, "keys") and "Values" in node:
                out["fields"][grp] = np.asarray(node["Values"])
            elif hasattr(node, "keys"):
                out["fields"][grp] = {k: np.asarray(node[k])
                                      for k in node.keys()}
    return out


def read_eigen(filename: str) -> dict:
    """Read an eigenvector file written by utils.hdf5
    .save_eigenvectors (layout of matlab/readhdf5.m:62-90): returns
    {"eigenvalues": complex array, "alphas", "betas", "vectors":
    list of complex flat arrays}."""
    import h5py
    with h5py.File(filename, "r") as f:
        ev = f["EigenValues"]
        alphas = (np.asarray(ev["AlphaRe"])
                  + 1j * np.asarray(ev["AlphaIm"]))
        betas = (np.asarray(ev["BetaRe"])
                 + 1j * np.asarray(ev["BetaIm"]))
        vectors = []
        k = 0
        while f"EV_Real_{k}" in f:
            vectors.append(np.asarray(f[f"EV_Real_{k}"]["Values"])
                           + 1j * np.asarray(f[f"EV_Imag_{k}"]["Values"]))
            k += 1
    lam = np.where(betas != 0, alphas / np.where(betas == 0, 1, betas),
                   np.inf)
    return {"eigenvalues": lam, "alphas": alphas, "betas": betas,
            "vectors": vectors}


def read_cdata(filename: str = "cdata.txt") -> dict:
    """Parse the continuation data table (Continuation.H:1276-1319
    columns: par, ds, |x|, |F|, NR, MV + model extensions) into a dict
    of named numpy columns."""
    with open(filename) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    header = None
    rows = []
    for ln in lines:
        if ln.lstrip().startswith("#"):
            header = ln.lstrip().lstrip("#").split()
            continue
        try:
            rows.append([float(tok) for tok in ln.split()])
        except ValueError:
            continue
    if not rows:
        return {}
    data = np.asarray(rows)
    if header is None or len(header) != data.shape[1]:
        header = [f"col{i}" for i in range(data.shape[1])]
    return {name: data[:, i] for i, name in enumerate(header)}


def read_tdata(filename: str = "tdata.txt") -> dict:
    """Transient table (AdaptiveTransient.H:174-214)."""
    return read_cdata(filename)


def state_to_grid(state_flat, n: int, m: int, l: int,
                  variables=OCEAN_VARS) -> dict:
    """Reshape a flat state (row = nun*((k*m + j)*n + i) + var,
    matetc.F90:51-146 find_row2) into {"u": (l, m, n) array, ...};
    auxiliary unknowns appended past n*m*l*nun are returned under
    "aux"."""
    nun = len(variables)
    core = np.asarray(state_flat[:nun * n * m * l])
    aux = np.asarray(state_flat[nun * n * m * l:])
    grid = core.reshape(l, m, n, nun)
    out = {v: grid[..., q] for q, v in enumerate(variables)}
    if aux.size:
        out["aux"] = aux
    return out


def read_profile(filename: str = "profile_output") -> dict:
    """Parse the profile table written by utils.logging.print_profile
    (GlobalDefinitions.C:220-280 analog) into
    {label: {"total": s, "calls": k, "avg": s}}."""
    out = {}
    pat = re.compile(r"^\s*(.+?)\s{2,}([\d.eE+-]+)\s+(\d+)\s+"
                     r"([\d.eE+-]+)\s*$")
    with open(filename) as f:
        for ln in f:
            mt = pat.match(ln)
            if mt:
                label, tot, calls, avg = mt.groups()
                out[label.strip()] = {"total": float(tot),
                                      "calls": int(calls),
                                      "avg": float(avg)}
    return out
