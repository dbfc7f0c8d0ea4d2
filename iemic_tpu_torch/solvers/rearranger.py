"""Variable-blocked (rearranged) view of the stencil Jacobian and a
Teko-style block preconditioner built on it (PyTorch).

Port of ``iemic_tpu/solvers/rearranger.py`` (the reference's experimental
Teko path, src/ocean/Rearranger.H:23-60 and TekoPreconditioner.H:39-88).
No reordering is needed: the stencil tensor An(27, A, B, l, m, n) is the
blocked operator, and a block is the sub-tensor of its row and column
variables applied matrix-free.  The preconditioner is a block
Gauss-Seidel sweep over the groups X = [u, v, w, p] and Y = [T, S], each
group's inverse approximated by its exact batched vertical-column solve.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.stencil import UU, VV, WW, PP, TT, SS, apply_stencil
from .preconditioner import inv, column_blocks, apply_col_inv

# variable groups of the De Niet blocking (Rearranger.H:47-53)
GROUPS = {
    "uv": (UU, VV),
    "w": (WW,),
    "p": (PP,),
    "ST": (TT, SS),
}

# the 10 structurally nonzero blocks: key -> (row group, col group)
BLOCK_KEYS = {
    "A_uv": ("uv", "uv"),   # momentum operator (incl. Coriolis)
    "E_uv": ("uv", "w"),    # vertical advection of momentum
    "G_uv": ("uv", "p"),    # horizontal pressure gradient
    "G_w":  ("w", "p"),     # vertical pressure gradient (hydrostatic)
    "B_ST": ("w", "ST"),    # buoyancy T,S -> w
    "D_uv": ("p", "uv"),    # horizontal divergence
    "D_w":  ("p", "w"),     # vertical divergence
    "B_uv": ("ST", "uv"),   # tracer advection by u,v
    "B_w":  ("ST", "w"),    # tracer advection by w
    "A_ST": ("ST", "ST"),   # tracer operator (incl. mixing)
}

# diagonal "dummy row" fixes (land cells, surface w, pressure Dirichlet
# points) live outside the 10 physics blocks
DUMMY_KEYS = {
    "D_ww": ("w", "w"),
    "D_pp": ("p", "p"),
}


def apply_stencil_rect(An_sub: torch.Tensor, x_cols: torch.Tensor, *,
                       periodic: bool) -> torch.Tensor:
    """Rectangular-block stencil matvec: An_sub (27, nA, nB, l, m, n)
    applied to x_cols (nB, l, m, n) -> (nA, l, m, n)."""
    return apply_stencil(An_sub, x_cols, periodic=periodic)


class Rearranger:
    """Blocked view of a stencil Jacobian (Rearranger.H:23-60)."""

    def __init__(self, An: torch.Tensor, *, periodic: bool):
        self.An = An
        self.periodic = periodic

    def sub(self, rows, cols) -> torch.Tensor:
        """Coefficient sub-tensor for a (rows, cols) variable block."""
        return self.An[:, list(rows)][:, :, list(cols)]

    def block(self, key: str):
        """Matvec closure for one named block: x_cols -> y_rows."""
        rg, cg = {**BLOCK_KEYS, **DUMMY_KEYS}[key]
        sub = self.sub(GROUPS[rg], GROUPS[cg])
        periodic = self.periodic
        return lambda xc: apply_stencil_rect(sub, xc, periodic=periodic)

    def nonzero_pattern(self) -> dict:
        """Max |coefficient| per (row group, col group): the analog of
        the reference's numNonzBlocks_ = 10 structure check."""
        return {(rg, cg): float(torch.amax(torch.abs(self.sub(rows, cols))))
                for rg, rows in GROUPS.items()
                for cg, cols in GROUPS.items()}

    def apply_blocked(self, x: torch.Tensor) -> torch.Tensor:
        """Full matvec reassembled from the named blocks (the finalMatrix_
        rebuild check, Rearranger.H:57-58).  Structurally zero blocks
        (e.g. w <- uv) are not applied; equality with the plain stencil
        matvec verifies the tiling."""
        y = torch.zeros_like(x)
        for key, (rg, cg) in {**BLOCK_KEYS, **DUMMY_KEYS}.items():
            y[list(GROUPS[rg])] += self.block(key)(x[list(GROUPS[cg])])
        return y


# ---------------------------------------------------------------------
# Teko-style block preconditioner
# ---------------------------------------------------------------------

def _column_inverse_sub(An: torch.Tensor, vars_: tuple, *, shift_p: bool,
                        eps: float = 1e-8) -> torch.Tensor:
    """Batched inverses of the vertical-column blocks restricted to a
    variable subset (the per-group 'inverse factory'), with the rank-one
    shift of the column-constant pressure mode when the group holds p
    (as preconditioner.build_column_blocks)."""
    vars_ = list(vars_)
    Asub = An[:, vars_][:, :, vars_]
    _, nv, _, l, m, n = Asub.shape
    d = nv * l
    B = column_blocks(Asub[4], Asub[13], Asub[22])
    if shift_p:
        e = An.new_zeros(d)
        e[vars_.index(PP)::nv] = 1.0 / np.sqrt(float(l))
        scale = torch.amax(torch.abs(B), dim=(1, 2), keepdim=True)
        B = B + torch.clamp(scale, min=1.0) * e[:, None] * e[None, :]
    return inv(B + eps * torch.eye(d, dtype=An.dtype, device=An.device))


_XVARS = (UU, VV, WW, PP)
_YVARS = (TT, SS)


def build(An: torch.Tensor, *, periodic: bool) -> dict:
    """Factor the Teko-style preconditioner for a Jacobian An."""
    xv, yv = list(_XVARS), list(_YVARS)
    return {
        "Minv_X": _column_inverse_sub(An, _XVARS, shift_p=True),
        "Minv_Y": _column_inverse_sub(An, _YVARS, shift_p=False),
        "C_XY": An[:, xv][:, :, yv].contiguous(),
        "C_YX": An[:, yv][:, :, xv].contiguous(),
    }


def apply(fac: dict, r: torch.Tensor, *, periodic: bool,
          sweeps: int = 1) -> torch.Tensor:
    """One (or more) block Gauss-Seidel sweeps
        z_Y = Minv_Y r_Y
        z_X = Minv_X (r_X - C_XY z_Y)
        [extra sweeps re-relax both groups]
    (TekoPreconditioner::ApplyInverse, TekoPreconditioner.H:63-88, with
    an LU-block inverse factory)."""
    xv, yv = list(_XVARS), list(_YVARS)
    rX, rY = r[xv], r[yv]
    zY = apply_col_inv(fac["Minv_Y"], rY)
    zX = apply_col_inv(
        fac["Minv_X"],
        rX - apply_stencil_rect(fac["C_XY"], zY, periodic=periodic))
    for _ in range(sweeps - 1):
        zY = apply_col_inv(
            fac["Minv_Y"],
            rY - apply_stencil_rect(fac["C_YX"], zX, periodic=periodic))
        zX = apply_col_inv(
            fac["Minv_X"],
            rX - apply_stencil_rect(fac["C_XY"], zY, periodic=periodic))
    z = torch.empty_like(r)
    z[xv] = zX
    z[yv] = zY
    return z
