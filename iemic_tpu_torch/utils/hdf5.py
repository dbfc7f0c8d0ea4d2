# Copied from iemic_tpu/utils/hdf5.py (numpy-only; importing iemic_tpu would import jax).
"""HDF5 checkpoint I/O, layout-compatible with the reference.

h5py is imported inside each function: the package imports without it.

The reference writes states through EpetraExt::HDF5
(src/utils/Model.H:254-310 saveStateToFile): dataset ``/State/Values``
holding the flat state in linear-map (natural row) ordering, scalar
datasets ``/Parameters/<name>``, grid metadata under ``/Grid``, and
eigen data under ``/EV_Real_<k>``, ``/EigenValues`` (read back by
matlab/readhdf5.m).  Using the same natural row ordering here means
checkpoints are interchangeable with the reference's and restart with
any device count is automatic (arrays reshard on load).

Saves are double-buffered: the previous output is first copied to
``<file>.bak`` (Model.H:254-258).
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def save_state(filename: str, state_flat: np.ndarray,
               parameters: dict[str, float],
               grid_meta: dict | None = None,
               extras: dict[str, np.ndarray] | None = None,
               backup: bool = True) -> None:
    if backup and os.path.exists(filename):
        shutil.copyfile(filename, filename + ".bak")

    import h5py
    with h5py.File(filename, "w") as f:
        g = f.create_group("State")
        ds = g.create_dataset("Values", data=np.asarray(state_flat))
        ds.attrs["GlobalLength"] = len(state_flat)
        p = f.create_group("Parameters")
        for name, val in parameters.items():
            p.create_dataset(name, data=float(val))
        if grid_meta:
            gg = f.create_group("Grid")
            for k, v in grid_meta.items():
                gg.create_dataset(k, data=v)
        if extras:
            for k, v in extras.items():
                grp = f.create_group(k)
                grp.create_dataset("Values", data=np.asarray(v))


def load_state(filename: str):
    """Returns (state_flat, parameters dict) or (None, {}) if the file
    does not exist (reference behavior: continue with trivial state)."""
    if not os.path.exists(filename):
        return None, {}
    import h5py
    with h5py.File(filename, "r") as f:
        state = np.asarray(f["State/Values"])
        pars = {}
        if "Parameters" in f:
            for name in f["Parameters"]:
                pars[name] = float(np.asarray(f["Parameters"][name]))
        return state, pars


def save_eigenvectors(filename: str, alphas, betas, vectors,
                      grid_meta: dict | None = None) -> None:
    """Eigen data layout read by matlab/readhdf5.m:62-90."""
    import h5py
    with h5py.File(filename, "w") as f:
        md = f.create_group("MetaData")
        md.create_dataset("NumEigs", data=len(alphas))
        ev = f.create_group("EigenValues")
        ev.create_dataset("AlphaRe", data=np.real(alphas))
        ev.create_dataset("AlphaIm", data=np.imag(alphas))
        ev.create_dataset("BetaRe", data=np.real(betas))
        ev.create_dataset("BetaIm", data=np.imag(betas))
        for k, v in enumerate(vectors):
            f.create_group(f"EV_Real_{k}").create_dataset(
                "Values", data=np.real(v))
            f.create_group(f"EV_Imag_{k}").create_dataset(
                "Values", data=np.imag(v))
