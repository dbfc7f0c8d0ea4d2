"""Matrix-free 27-point x 6-variable stencil operator (PyTorch).

Port of ``iemic_tpu/ops/stencil.py``.  The coefficient tensor itself is
the Jacobian and is applied matrix-free; see that module for the
reference semantics (usrc.F90:588-604, assemble.F90:57-179).

Conventions (0-based everywhere):
  * state  x   : (nun, l, m, n)        = x[B, k, j, i]
  * stencil An : (np, nun, nun, l, m, n) = An[p, A, B, k, j, i], meaning
      d/dt A|(i,j,k) = sum_p,B  An[p,A,B,k,j,i] * B|(i+di_p, j+dj_p, k+dk_p)
  * stencil location p: q = p % 9, di = q // 3 - 1, dj = q % 3 - 1,
    dk = 0 / -1 / +1 for p < 9 / p < 18 / p >= 18.

The flat-vector order used for I/O and cross-checks is the reference's
row numbering row = nun*((k*m + j)*n + i) + X (matetc.F90:123-144).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NP = 27
NUN = 6

# unknown enumeration (reference par.F90:69-75, 0-based here)
UU, VV, WW, PP, TT, SS = 0, 1, 2, 3, 4, 5

# grid point types (reference par.F90:77-81)
OCEAN, LAND, WATER, PERIO = 0, 1, 2, 3


def offsets() -> np.ndarray:
    """(27, 3) array of (di, dj, dk) stencil offsets."""
    offs = np.zeros((NP, 3), dtype=np.int64)
    for p in range(NP):
        q = p % 9
        offs[p] = (q // 3 - 1, q % 3 - 1, (0, -1, 1)[p // 9])
    return offs


_OFFS = offsets()


def pad_state(x: torch.Tensor, periodic: bool) -> torch.Tensor:
    """Zero-pad (..., l, m, n) -> (..., l+2, m+2, n+2); wrap the x-dim
    if periodic (assemble.F90:171-177); j and k never wrap."""
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    if periodic:
        xp = torch.cat([xp[..., -2:-1], xp[..., 1:-1], xp[..., 1:2]],
                       dim=-1)
    return xp


_WINDOW_INDEX = {}


def _window_index(l: int, m: int, n: int, periodic: bool,
                  device) -> torch.Tensor:
    """Flat gather index (27*l*m*n,) of the 27 shifted windows into x
    flattened over (l, m, n) with one zero appended at position l*m*n,
    which every neighbour outside the grid reads (zero in j and k, and
    in i unless periodic)."""
    key = (l, m, n, periodic, torch.device(device))
    idx = _WINDOW_INDEX.get(key)
    if idx is None:
        k = np.arange(l)[:, None, None]
        j = np.arange(m)[None, :, None]
        i = np.arange(n)[None, None, :]
        out = np.empty((NP, l, m, n), np.int64)
        for p, (di, dj, dk) in enumerate(_OFFS):
            k2, j2, i2 = k + dk, j + dj, i + di
            valid = (k2 >= 0) & (k2 < l) & (j2 >= 0) & (j2 < m)
            if periodic:
                i2 = i2 % n
            else:
                valid = valid & (i2 >= 0) & (i2 < n)
            out[p] = np.where(valid, (k2 * m + j2) * n + i2, l * m * n)
        idx = _WINDOW_INDEX[key] = torch.as_tensor(out.reshape(-1),
                                                   device=device)
    return idx


def windows(x: torch.Tensor, periodic: bool) -> torch.Tensor:
    """The 27 shifted windows of x (..., nun, l, m, n) ->
    (..., 27, nun, l, m, n): window p reads x at offset p.  One gather
    from x with a zero appended (two launches)."""
    l, m, n = x.shape[-3:]
    lead = x.shape[:-3]
    xe = F.pad(x.reshape(*lead, l * m * n), (0, 1))
    w = xe.index_select(-1, _window_index(l, m, n, periodic, x.device))
    return w.reshape(*lead, NP, l, m, n).movedim(-4, -5)


def apply_stencil(An: torch.Tensor, x: torch.Tensor, *,
                  periodic: bool) -> torch.Tensor:
    """y[A] = sum_{p,B} An[p,A,B] * shift_p(x[B]).

    Matrix-free equivalent of the reference's CSR SpMV (matetc.F90:147-166
    matAvec); works in the common dtype of An and x.
    """
    return (An * windows(x, periodic).unsqueeze(1)).sum(dim=(0, 2))


def stencil_to_csr(An, *, periodic: bool
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble the stencil tensor into CSR arrays (data, indices, indptr)
    in the reference's flat row ordering (assemble.F90:57-142 fillcolA);
    zero entries are kept out.  Host-side numpy, for cross-checks."""
    An = An.detach().cpu().numpy() if isinstance(An, torch.Tensor) \
        else np.asarray(An)
    _, nun, _, l, m, n = An.shape
    ndim = nun * l * m * n

    kk, jj, ii = np.meshgrid(np.arange(l), np.arange(m), np.arange(n),
                             indexing="ij")
    rows_base = ((kk * m + jj) * n + ii) * nun

    row_list, col_list, val_list = [], [], []
    for p in range(NP):
        di, dj, dk = _OFFS[p]
        k2, j2, i2 = kk + dk, jj + dj, ii + di
        valid = (0 <= k2) & (k2 < l) & (0 <= j2) & (j2 < m)
        if periodic:
            i2 = i2 % n
        else:
            valid &= (0 <= i2) & (i2 < n)
        cols_base = ((np.clip(k2, 0, l - 1) * m + np.clip(j2, 0, m - 1))
                     * n + np.clip(i2, 0, n - 1)) * nun
        for a in range(nun):
            for b in range(nun):
                c = An[p, a, b]
                nz = valid & (c != 0.0)
                if not nz.any():
                    continue
                row_list.append(rows_base[nz] + a)
                col_list.append(cols_base[nz] + b)
                val_list.append(c[nz])
    rows = np.concatenate(row_list)
    cols = np.concatenate(col_list)
    vals = np.concatenate(val_list)
    # sum duplicates (periodic wrap on tiny grids)
    key = rows.astype(np.int64) * ndim + cols
    uniq, inv = np.unique(key, return_inverse=True)
    data = np.zeros(len(uniq))
    np.add.at(data, inv, vals)
    indices = (uniq % ndim).astype(np.int32)
    indptr = np.zeros(ndim + 1, dtype=np.int64)
    np.add.at(indptr, uniq // ndim + 1, 1)
    np.cumsum(indptr, out=indptr)
    return data, indices, indptr


def from_flat(x_flat: torch.Tensor, l: int, m: int, n: int) -> torch.Tensor:
    """Reference flat vector (row = nun*((k*m+j)*n+i)+X) -> (nun,l,m,n)."""
    return x_flat.reshape(l, m, n, NUN).permute(3, 0, 1, 2)


def to_flat(x: torch.Tensor) -> torch.Tensor:
    """(nun,l,m,n) -> reference flat ordering."""
    return x.permute(1, 2, 3, 0).reshape(-1)
