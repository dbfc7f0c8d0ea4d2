"""Carry state from the JAX package into the port.

Each function takes arrays as numpy (``np.asarray`` of a JAX array) and
returns or installs tensors on a given device, so both packages compute
from the same inputs.  Flat vectors use the reference's row ordering,
the same as ``ops.stencil.to_flat`` / ``from_flat``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.stencil import from_flat

F64 = torch.float64


def tensor(a, device, dtype=F64) -> torch.Tensor:
    """numpy array -> a tensor of its own on device (a JAX array's numpy
    view is read-only)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def state(x, l: int, m: int, n: int, device) -> torch.Tensor:
    """Ocean state as (6, l, m, n) from field layout or a flat vector."""
    x = np.asarray(x)
    if x.ndim == 1:
        return from_flat(tensor(x, device), l, m, n).contiguous()
    return tensor(x.reshape(6, l, m, n), device)


def stencil(An, device) -> torch.Tensor:
    """Stencil tensor An (27, 6, 6, l, m, n)."""
    return tensor(An, device)


def install_state(ocean, x) -> None:
    g = ocean.grid
    ocean.set_state(state(x, g.l, g.m, g.n, ocean.device))


def install_par(model, par) -> None:
    """The whole parameter vector of an ocean (30 entries), atmosphere
    (7) or sea ice (5)."""
    model.par = tensor(par, model.device)


def install_flat_state(model, x) -> None:
    """The flat state of an atmosphere (3*n*m + 1), a sea ice (4*n*m + 1)
    or a coupled model (the ocean's (6, l, m, n), the atmosphere's and the
    sea ice's one after the other), in the layout both packages keep."""
    model.set_state(tensor(np.asarray(x).reshape(-1), model.device))


def install_forcing(ocean, **fields) -> None:
    """Forcing fields by name (taux, tauy, tatm, emip, spert, ...);
    None keeps the field unset."""
    ocean.fields = ocean.fields._replace(**{
        k: None if v is None else tensor(v, ocean.device)
        for k, v in fields.items()})


def install_land_mask(ocean, landm) -> None:
    """A finalized padded (l+2, m+2, n+2) land mask; rebuilds every
    mask-dependent operator of the ocean."""
    ocean.landm = np.asarray(landm)
    ocean._setup_mask_operators()


def install_monthly_forcing(ocean, **monthly) -> None:
    """Monthly fields of the seasonal cycle by name (mtaux, mtauy, mtatm,
    memip: (12, m, n); mtemp, msalt: (12, l, m, n)) into the ocean's
    ``monthly_forcing``, host-side numpy as the port keeps them, so that
    both packages run the same seasonal cycle."""
    for k, v in monthly.items():
        setattr(ocean.monthly_forcing, k, np.array(v, dtype=np.float64))



def install_topo_leg(topo, *, masks, k, delta, state_A, vecM) -> None:
    """A JAX Topo leg into the port's Topo: the raw (l, m, n) masks, the
    leg index k (A = masks[k], B = masks[k+1]), Delta, the mask-A state
    x_A and the mass diagonal of mask B (field layout), with the row
    scaling that follows from it.  The port's ocean must hold mask B
    already (install_land_mask with the JAX ocean's padded mask)."""
    g = topo.model.grid
    dev = topo.model.device
    topo.set_masks([np.asarray(mk) for mk in masks])
    topo.set_mask_index(int(k))
    topo.delta = float(delta)
    topo.state_A = state(state_A, g.l, g.m, g.n, dev)
    topo.vecM = state(vecM, g.l, g.m, g.n, dev)
    topo._scale = (topo.vecM.abs() < 1e-12).to(F64)
    topo.norm_fB = np.inf
