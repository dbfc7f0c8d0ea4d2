"""Depth-averaged saddle-point operator and the SIMPLE-type
preconditioners (PyTorch).

Port of ``iemic_tpu/solvers/saddlepoint.py`` (the reference's
SaddlepointMatrix + SppSimplePrec,
TRIOS_Saddlepoint.H:28-95, 259-276): the saddle operator is the
(9, 3, 3, m, n) depth-averaged stencil ``Spp``; the approximate momentum
inverse is the pointwise 2x2 inverse of its (u, v) diagonal; the pressure
Schur complement Chat = -D diag(A)^{-1} G is composed symbolically into a
25-point stencil, with a 2D multigrid on it.

  'SI' (SIMPLE):  u* = Ainv r_u;  solve Chat dp = D u* - r_p;
                  u = u* - Ainv G dp;  p = dp
  'SL' (SIMPLE(L)): as SI but skips the final momentum correction
  'SR' (SIMPLER): a pressure prediction from the momentum residual
                  precedes the SIMPLE sweep
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.stencil import offsets
from . import mg as _mg
from .mg import shift2d, apply25, _O25_INDEX

_OFFS9 = offsets()[:9]                       # (di, dj, 0) center plane


class SppSimple(NamedTuple):
    """Factored SIMPLE preconditioner state."""
    Spp: torch.Tensor        # (9, 3, 3, m, n) the saddle operator
    auv_inv: torch.Tensor    # (2, 2, m, n) pointwise momentum inverse
    chat: torch.Tensor       # (25, m, n) composed pressure Schur stencil
    chat_dinv: torch.Tensor  # (m, n) inverse diagonal of chat
    nullmodes: torch.Tensor  # (2, m, n) barotropic pressure null modes
    chat_mg: object = None   # mg.MG2DPrec on chat


def build_simple(Spp: torch.Tensor, sv2d: torch.Tensor, *, periodic: bool,
                 prolong_w: float = 0.25) -> SppSimple:
    """Factor the SIMPLE pieces from the depth-averaged saddle stencil
    (variable order u, v, p)."""
    _, _, _, m, n = Spp.shape
    A = Spp[4, :2, :2]                          # (2, 2, m, n)
    det = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    scale = torch.amax(torch.abs(A), dim=(0, 1))
    ok = torch.abs(det) > 1e-12 * torch.clamp(scale, min=1e-30) ** 2
    det = torch.where(ok, det, 1.0)
    auv_inv = torch.stack([
        torch.stack([A[1, 1] / det, -A[0, 1] / det]),
        torch.stack([-A[1, 0] / det, A[0, 0] / det])])
    auv_inv = torch.where(ok[None, None], auv_inv, 0.0)
    # land columns (all-zero momentum diag) get identity
    eye2 = torch.eye(2, dtype=Spp.dtype, device=Spp.device)
    auv_inv = auv_inv + torch.where(ok, 0.0, 1.0)[None, None] \
        * eye2[:, :, None, None]

    # ---- Chat = -D Ainv G, composed symbolically --------------------
    D = Spp[:, 2, :2]                           # (9, 2, m, n)
    G = Spp[:, :2, 2]                           # (9, 2, m, n)
    chat = Spp.new_zeros((25, m, n))
    for a, (dia, dja, _) in enumerate(_OFFS9):
        dia, dja = int(dia), int(dja)
        ainv_s = shift2d(auv_inv, dia, dja, periodic)     # (2, 2, m, n)
        for b, (dib, djb, _) in enumerate(_OFFS9):
            dib, djb = int(dib), int(djb)
            G_s = shift2d(G[b], dia, dja, periodic)       # (2, m, n)
            coef = -torch.einsum('rji,rcji,cji->ji', D[a], ainv_s, G_s)
            chat[_O25_INDEX[(dia + dib, dja + djb)]] += coef

    dC = chat[_O25_INDEX[(0, 0)]]
    okc = torch.abs(dC) > 1e-14 * torch.clamp(
        torch.amax(torch.abs(chat), dim=0), min=1e-30)
    chat_dinv = torch.where(okc, 1.0 / torch.where(okc, dC, 1.0), 1.0)
    chat_mg = _mg.build2d(chat, periodic=periodic, prolong_w=prolong_w)
    return SppSimple(Spp=Spp, auv_inv=auv_inv, chat=chat,
                     chat_dinv=chat_dinv, nullmodes=sv2d, chat_mg=chat_mg)


def deflate(x: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Project the (orthonormal) modes out of x, one after the other."""
    for q in range(modes.shape[0]):
        sv = modes[q]
        x = x - torch.sum(sv * x) * sv
    return x


def apply_stencil_2d(S: torch.Tensor, offs, x: torch.Tensor,
                     periodic: bool) -> torch.Tensor:
    """y(j,i) = sum_q S[q,j,i] * x(j+dj_q, i+di_q) for scalar planes, with
    offsets offs of reach up to 2."""
    acc = 0.0
    for q, (di, dj) in enumerate(offs):
        acc = acc + S[q] * shift2d(x, int(di), int(dj), periodic)
    return acc


def apply_saddle(Spp: torch.Tensor, x: torch.Tensor, periodic: bool
                 ) -> torch.Tensor:
    """The saddle operator action [A G; D 0] x on (3, m, n) vectors (the
    SaddlepointMatrix::Apply analog, TRIOS_Saddlepoint.H:28-95)."""
    from .bgs import _apply_2d
    return _apply_2d(Spp, x, periodic)


def _chat_solve(sp: SppSimple, b: torch.Tensor, periodic: bool,
                iters: int) -> torch.Tensor:
    """Inner FGMRES on Chat x = b, MG-preconditioned, with the
    barotropic null modes deflated (TRIOS_Saddlepoint.H:259-276)."""
    from .fgmres import fgmres_flat
    shape = b.shape
    b = deflate(b, sp.nullmodes)

    def mv(v):
        return apply25(sp.chat, v.reshape(shape), periodic).reshape(-1)

    def pc(v):
        z = _mg.apply2d(sp.chat_mg, v.reshape(shape), periodic=periodic)
        return deflate(z, sp.nullmodes).reshape(-1)

    res = fgmres_flat(mv, pc, b.reshape(-1), torch.zeros_like(b).reshape(-1),
                      1e-6, iters)
    return deflate(res.x.reshape(shape), sp.nullmodes)


def apply_simple(sp: SppSimple, r: torch.Tensor, *, periodic: bool,
                 scheme: str = "SI", chat_iters: int = 12) -> torch.Tensor:
    """One SIMPLE / SIMPLE(L) / SIMPLER sweep z ~= Spp^{-1} r; r: (3, m, n)
    = (r_u, r_v, r_p).  Scheme semantics follow
    SppSimplePrec::ApplyInverse (TRIOS_Saddlepoint.H:28-95)."""
    ruv, rp = r[:2], r[2]

    def ainv(v):
        return torch.einsum('rcji,cji->rji', sp.auv_inv, v)

    def Dmul(v):
        acc = 0.0
        for a, (di, dj, _) in enumerate(_OFFS9):
            for c in range(2):
                acc = acc + sp.Spp[a, 2, c] * shift2d(
                    v[c], int(di), int(dj), periodic)
        return acc

    def Gmul(p):
        rows = []
        for c in range(2):
            acc = 0.0
            for a, (di, dj, _) in enumerate(_OFFS9):
                acc = acc + sp.Spp[a, c, 2] * shift2d(
                    p, int(di), int(dj), periodic)
            rows.append(acc)
        return torch.stack(rows)

    if scheme == "SR":
        # SIMPLER: pressure prediction from the momentum residual
        p0 = _chat_solve(sp, Dmul(ainv(ruv)) - rp, periodic, chat_iters)
        ruv = ruv - Gmul(p0)
    else:
        p0 = torch.zeros_like(rp)
    ustar = ainv(ruv)
    dp = _chat_solve(sp, Dmul(ustar) - rp, periodic, chat_iters)
    u = ustar if scheme == "SL" else ustar - ainv(Gmul(dp))
    return torch.cat([u, (p0 + dp)[None]])
