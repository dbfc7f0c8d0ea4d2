"""The ocean's residual and Jacobian partitioned over the ranks of a Domain.

The reference assembles F and J on every subdomain extended by a 2-deep
overlap: the Standard->Assembly import before each evaluation
(src/trios/TRIOS_Domain.H:273-290, used at src/ocean/THCM.C:972,999).  The
JAX package lets GSPMD partition the serial assembly.  Here each rank
evaluates the port's own serial assembly (``assembly.lin``,
``assembly.nlin``, ``Mixing.rhs``/``Mixing.stencil``, then
``assembly.boundaries``) on its block extended by a 2-deep state halo
(``halo.halo_extend``) and keeps the block's rows.  No row of the block
reads past the halo: An(x) reads x at reach 1 (the staggered velocities
one face further), F = An x reads x at reach 1, and the mixing fluxes
read T and S at reach 1.

Nothing that depends only on the land mask is rebuilt on a window: the
linear atoms, the velocity-point mask of ``nonlin.usol`` and the
boundary masks are computed once for the whole grid and sliced, so that
the periodic seam and the global walls are treated as the serial
assembly treats them.  Where a window wraps across the seam, the serial
assembly's two seam rules that a window cannot see are restored: the
zonal advection atoms' loop bounds at the grid's first and last columns,
and the last column's reading of its periodic ghost's top-layer w
(``nonlin._x_bounds``, ``nonlin._wz4``).  The window stops at a global wall, where the
serial wall treatment applies; in x it wraps across the periodic seam
when px > 1, and with px == 1 it spans the whole circle and stays
periodic.  Global reductions stay global: the forcing (its area-integral
corrections, ``assembly.qint``) depends on the parameters and not on the
state, so every rank computes it on the whole surface and keeps its
block; the salinity integral row is a sum over the ranks, written by the
rank that owns its cell; the mixing's activity gates (Mixing 2) are sums
over the ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.ocean import assembly
from ..models.ocean.nonlin import velocity_keep
from ..ops.stencil import TT, SS, WW, offsets, pad_state

# depth of the state halo the assembly reads (the reference's overlap)
HALO_DEPTH = 2
_OFFS = offsets()


class BlockWindow:
    """This rank's block of the grid extended by the state halo: the rows
    and columns of the window, its slices of everything the assembly
    reads from the land mask, and the window's Grid (the global grid's
    coordinates and bounds, sliced; never a grid made from a sub-range's
    bounds, since the forcing profiles read the global ymin/ymax)."""

    def __init__(self, ocean, domain, depth: int = HALO_DEPTH):
        cfg, grid = ocean.cfg, ocean.grid
        l, m, n = cfg.l, cfg.m, cfg.n
        ml, nl = domain.local_shape
        self.depth, self.ml, self.nl = depth, ml, nl
        # halo rows/columns kept on each side: none at a global wall, and
        # none in x where one rank spans the periodic circle
        self.ylo = depth if domain.south is not None else 0
        self.yhi = depth if domain.north is not None else 0
        self.xlo = depth if domain.west is not None else 0
        self.xhi = depth if domain.east is not None else 0
        self.periodic = bool(cfg.periodic) and domain.px == 1
        wrap = bool(cfg.periodic) and domain.px > 1
        rows = np.arange(domain.j0 - self.ylo, domain.j0 + ml + self.yhi)
        cols = np.arange(domain.i0 - self.xlo, domain.i0 + nl + self.xhi)
        mw, nw = len(rows), len(cols)
        self.shape = (l, mw, nw)
        # the mask's ghost border: the neighbours' cells inside the grid,
        # the global ghost cells at its edge
        lrows = np.arange(rows[0], rows[-1] + 3)
        # staggered (velocity-point) indices: point s is the face south
        # (west) of window row (column) s, i.e. north (east) of the
        # global row (column) before it
        srows = np.arange(rows[0], rows[0] + mw + 1)
        if wrap:
            lcols = 1 + np.arange(cols[0] - 1, cols[-1] + 2) % n
            scols = 1 + np.arange(cols[0] - 1, cols[-1] + 1) % n
        else:
            lcols = np.arange(cols[0], cols[-1] + 3)
            scols = np.arange(cols[0], cols[0] + nw + 1)
        cols = cols % n
        # the grid's first and last columns, where the window wraps
        # across the seam (nonlin._x_bounds)
        self.edges = None
        if wrap:
            self.edges = tuple(torch.as_tensor(c, device=domain.device)
                               for c in (cols == 0, cols == n - 1))
        self.landm = np.ascontiguousarray(ocean.landm[:, lrows][:, :, lcols])
        self.keep = np.ascontiguousarray(
            velocity_keep(ocean.landm, l, m, n)[:, srows][:, :, scols])
        jb = slice(domain.j0, domain.j0 + ml)
        ib = slice(domain.i0, domain.i0 + nl)
        masks = assembly.boundary_masks(ocean.landm, l, m, n)

        def block(b):
            return torch.as_tensor(np.ascontiguousarray(b[:, jb, ib]),
                                   device=domain.device)

        self.block_masks = {
            k: ({p: block(b) for p, b in v.items()} if k == "LM"
                else block(v)) for k, v in masks.items()}
        self.grid = dataclasses.replace(
            grid, n=nw, m=mw, periodic=self.periodic, x=grid.x[cols],
            xu=grid.xu[scols], y_ext=grid.y_ext[rows[0]:rows[-1] + 3],
            yv=grid.yv[srows])
        self.block_grid = dataclasses.replace(grid, n=nl, m=ml)
        self._rows = torch.as_tensor(rows, device=ocean.state.device)
        self._cols = torch.as_tensor(cols, device=ocean.state.device)
        self.device = domain.device

    def of(self, t: torch.Tensor) -> torch.Tensor:
        """The window of a global (..., m, n) tensor, on the rank's
        device."""
        t = t.index_select(-2, self._rows).index_select(-1, self._cols)
        return t.to(self.device).contiguous()

    def xedge(self, x_w: torch.Tensor):
        """``nonlin._x_bounds``' xedge for the window of the state x_w, or
        None where the window does not wrap."""
        if self.edges is None:
            return None
        return self.edges + (x_w[WW, -1],)

    def crop(self, t: torch.Tensor) -> torch.Tensor:
        """The block's rows of a window-shaped (..., mw, nw) tensor."""
        return t[..., self.ylo:self.ylo + self.ml,
                 self.xlo:self.xlo + self.nl]

    def state(self, x_l: torch.Tensor, domain) -> torch.Tensor:
        """The window of the state from this rank's block and the
        neighbours' halos (every rank calls it together)."""
        from .halo import halo_extend
        d = self.depth
        xe = halo_extend(x_l, domain, d)
        return xe[..., d - self.ylo:d + self.ml + self.yhi,
                  d - self.xlo:d + self.nl + self.xhi]

    def product(self, An_b: torch.Tensor, x_w: torch.Tensor) -> torch.Tensor:
        """The block's rows of An x from the block's stencil rows An_b and
        the window of x: apply_stencil's product on the block's windows
        (zero outside the grid, wrapped where the window is periodic)."""
        l = self.shape[0]
        xp = pad_state(x_w, self.periodic)
        j0, i0 = 1 + self.ylo, 1 + self.xlo
        windows = torch.stack([
            xp[:, 1 + dk:1 + dk + l, j0 + dj:j0 + dj + self.ml,
               i0 + di:i0 + di + self.nl]
            for (di, dj, dk) in _OFFS])
        return (An_b * windows.unsqueeze(1)).sum(dim=(0, 2))


def make_partitioned_assembly(ocean, domain):
    """(rhs, jac): this rank's block of the residual and of the stencil
    tensor, from its block of the state, evaluated on the block's window
    (see the module note).  ``rhs(x_l, par, int_correction=0.0)`` is
    ``Ocean._rhs``'s block with the salinity integral row (a sum over the
    ranks); ``jac(x_l, par)`` is ``Ocean._jacobian``'s block.  Neither
    gathers; every rank calls them together (halo exchange and sums)."""
    cfg = ocean.cfg
    win = BlockWindow(ocean, domain)
    gw = win.grid
    atoms = assembly.LinearAtoms(*(win.of(a) for a in ocean.atoms))
    mixing = None
    if ocean.mixing is not None:
        from ..models.ocean.mixing import Mixing
        mixing = Mixing(gw, win.landm, vmix=cfg.vmix, tap=cfg.tap,
                        rho_mixing=cfg.rho_mixing, alphaT=ocean._alphaT,
                        periodic=win.periodic, device=domain.device)
    int_coeff = domain.shard_state(ocean.int_coeff)
    _, k, j, i = ocean.rowintcon
    own = domain.owns(j, i)
    ir = (SS, k, j - domain.j0, i - domain.i0)

    def lin(par):
        msi = ocean.fields.msi
        return assembly.lin(
            atoms, par, gw, tres=cfg.tres, sres=cfg.sres,
            coupled_T=cfg.coupled_T, coupled_S=cfg.coupled_S, cpl=ocean.cpl,
            msi=None if msi is None else win.of(msi), QTnd=ocean.QTnd,
            QSnd=ocean.QSnd)

    def active(x_l):
        """The mixing's (T, S) gates of the whole state (Mixing 2), or
        None where the rows are always on."""
        if mixing is None or mixing.vmix <= 1:
            return None
        sq = domain.allreduce(torch.stack([torch.sum(x_l[TT] ** 2),
                                           torch.sum(x_l[SS] ** 2)]))
        return (torch.sqrt(sq) > 1e-12).to(x_l.dtype)

    frc = {}

    def forcing(par):
        """This block of the forcing, computed on the whole surface (its
        area-integral corrections are global) and kept while the
        parameters and the fields stay."""
        p = par.cpu().numpy().tobytes()
        if (frc.get("par") != p or frc.get("fields") is not ocean.fields
                or frc.get("cpl") is not ocean.cpl):
            frc.update(par=p, fields=ocean.fields, cpl=ocean.cpl,
                       F=domain.shard_state(ocean._frc(par)))
        return frc["F"]

    def boundaries(An_b):
        return assembly.boundaries(An_b, None, win.block_grid,
                                   masks=win.block_masks)

    def rhs(x_l, par, int_correction=0.0):
        x_w = win.state(x_l, domain)
        gates = active(x_l)
        zero = torch.zeros((27, 6, 6) + win.shape, dtype=x_w.dtype,
                           device=x_w.device)
        Nl = assembly.nlin(zero, x_w, par, gw, win.landm, win.periodic,
                           jac=False, keep=win.keep, xedge=win.xedge(x_w))
        An_b = boundaries(win.crop(lin(par) + Nl))
        F = win.product(An_b, x_w)
        if mixing is not None:
            F[TT:SS + 1] += win.crop(mixing.rhs(x_w, par, gates))
        F = F - forcing(par)
        if cfg.sres == 0:
            intval = domain.allreduce(torch.sum(int_coeff * x_l)[None])[0]
            if own:
                F[ir] = cfg.int_sign * (intval - int_correction)
        return F

    def jac(x_l, par):
        x_w = win.state(x_l, domain)
        gates = active(x_l)
        An = assembly.nlin(lin(par), x_w, par, gw, win.landm, win.periodic,
                           jac=True, keep=win.keep, xedge=win.xedge(x_w))
        if mixing is not None:
            An[:, TT:SS + 1, TT:SS + 1] += mixing.stencil(x_w, par, gates)
        return boundaries(win.crop(An)).contiguous()

    return rhs, jac
