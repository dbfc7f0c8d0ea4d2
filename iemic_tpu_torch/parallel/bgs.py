"""The block Gauss-Seidel preconditioner partitioned over the ranks of a
Domain: its factors built, and its sweep applied, on each rank's block.

The JAX package factors and applies the sweep under GSPMD on the sharded
stencil tensor (``iemic_tpu/parallel/halo.py``, ``make_sharded_solve``).
Torch has no GSPMD, so the sweep's grid operations are partitioned by
hand here, in :class:`PartitionedGrid`, and ``solvers.bgs`` keeps the one
copy of the sweep's order of operations (``bgs.build``/``bgs.apply`` with
``grid=``).  What each piece needs, z never being partitioned:

  * local: every sub-block, the column inverses, the rho/mu transform,
    the Dirichlet rows, the column solves of the sweep;
  * a 1-deep halo (``halo_pad_shard``) per sub-block stencil product, one
    per vector where two products take the same vector;
  * a sum over the ranks (``Domain.allreduce``) per dot product, norm and
    maximum: the null-mode projections and Gram-Schmidt, the
    integral-condition row (which the owning rank writes), the value of
    the residual at that row's point, and the inner FGMRES's
    Gram-Schmidt;
  * the zonal line solves (Auv's line correction, the ATS multigrid's
    smoother): a line spans the whole row of ranks, so each rank builds
    the line inverses from the three bands gathered along its row and
    keeps its own rows of them; a solve gathers the residual along the
    row (point-to-point messages within the row, no other rank's bytes)
    and multiplies by those rows;
  * the 3D multigrids (ATS's, and Auv's where asked): the finest level
    partitioned, the coarser levels whole on every rank, each rank's
    Galerkin contributions and restricted residual placed into the whole
    coarse field and summed over the ranks (2x2 aggregates straddle the
    blocks where a block side is odd), the prolongation sliced to the
    block; a hierarchy of one level (the whole grid at most 64 columns)
    is assembled whole the same way;
  * the depth-averaged 2D saddle: its operator Spp, point-block Jacobi
    inverses, SIMPLE factors, Chat multigrid and multigrid (m*n points,
    a twelfth of one 3D variable at 96x38x12) built whole on every rank
    from the summed Spp; a solve of it (scheme KRYLOV, orderings M2 and
    M3) makes its right-hand side whole by one sum over the ranks, runs
    its inner FGMRES on the whole field with no message round, and keeps
    its block of the result; the Chat V-cycle's input is made whole and
    its output sliced the same way.

Nothing gathers the stencil tensor (``Domain.gather``), but the pieces
above that are made whole on every rank are sums over the ranks of whole
fields.  On more than one rank every message round is counted
(``PartitionedGrid.rounds``: a sum over the ranks, a gather along a
row of ranks, each stage of a halo exchange that sends messages), and so
are the bytes of the whole fields summed (``whole_bytes``).  On one rank
every operation is the whole grid's, and the sweep equals the serial one
bit for bit; it may then replay its saddle iteration from CUDA graphs,
which cannot record the host-staged exchanges of more ranks.

Every branch of ``bgs.build`` and ``bgs.apply`` runs partitioned.  The
build is ``bgs.build``'s keywords over the JAX package's sharded solve's
(MG on ATS, :data:`SHARDED_BUILD`); ``check_branches`` refuses, before
the build, the sweep options ``bgs.apply`` itself refuses.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.ocean.ocean import _to_dtype
from ..ops import stencil_hopper
from ..ops.stencil import NP, offsets
from ..solvers import bgs
from ..solvers import mg as _mg
from .halo import halo_pad_shard

_OFFS = offsets()
_PADDED_INDEX = {}

# bgs.build's keywords of the JAX package's sharded solve
# (iemic_tpu/parallel/halo.py, make_sharded_solve): MG on ATS, the rest at
# bgs.build's defaults
SHARDED_BUILD = {"ts_precond": "MG"}


def check_branches(apply_opts: dict) -> None:
    """Raise ValueError for the bgs.apply options that bgs.apply refuses
    (an ordering other than M1, M2 and M3; the symmetric correction of an
    ordering other than M1), before any factor is built."""
    perm = apply_opts.get("permutation", 1)
    if perm not in (1, 2, 3):
        raise ValueError(f"BGS: invalid permutation {perm}")
    if apply_opts.get("symmetric") and perm != 1:
        raise ValueError("BGS: symmetric Gauss-Seidel requires "
                         "permutation == 1")


def int_row_of(ocean, scale: float):
    """bgs.build's int_row of the ocean's salinity integral-condition row
    times scale, None where the ocean has none."""
    return ((ocean.int_coeff, ocean.rowintcon, scale)
            if ocean.cfg.sres == 0 else None)


def _padded_index(l: int, ml: int, nl: int, device) -> torch.Tensor:
    """Flat gather index (27*l*ml*nl,) of the 27 windows of a block
    padded by one cell on every side, flattened over (l+2, ml+2, nl+2)."""
    key = (l, ml, nl, torch.device(device))
    idx = _PADDED_INDEX.get(key)
    if idx is None:
        k = np.arange(1, l + 1)[:, None, None]
        j = np.arange(1, ml + 1)[None, :, None]
        i = np.arange(1, nl + 1)[None, None, :]
        out = np.empty((NP, l, ml, nl), np.int64)
        for p, (di, dj, dk) in enumerate(_OFFS):
            out[p] = ((k + dk) * (ml + 2) + j + dj) * (nl + 2) + i + di
        idx = _PADDED_INDEX[key] = torch.as_tensor(out.reshape(-1),
                                                   device=device)
    return idx


class PartitionedGrid(_mg.Whole):
    """``mg.Whole``'s grid operations on this rank's block of the domain:
    the sweep's, the ATS multigrid's finest level's and the sharded
    matvec's.  On more than one rank ``rounds`` counts the message
    rounds (a halo exchange makes one for each partitioned axis) and
    ``whole_bytes`` the bytes of the whole fields summed over the ranks
    (:meth:`whole` and the coarse levels)."""

    def __init__(self, domain):
        super().__init__(domain.periodic)
        self.domain = domain
        self.rounds = 0
        self.whole_bytes = 0
        ml, nl = domain.local_shape
        self._block = (slice(domain.j0, domain.j0 + ml),
                       slice(domain.i0, domain.i0 + nl))
        self._many = domain.size > 1
        # halo_extend's stages that send messages: y, then x
        self._halo_rounds = (domain.py > 1) + (domain.px > 1)

    def _counted(self, rounds: int = 1):
        if self._many:
            self.rounds += rounds

    def _allreduce(self, t: torch.Tensor) -> torch.Tensor:
        self._counted()
        return self.domain.allreduce(t)

    def _whole_sum(self, t: torch.Tensor) -> torch.Tensor:
        self.whole_bytes += t.numel() * t.element_size()
        return self._allreduce(t)

    @property
    def reduce(self):
        return self._allreduce if self._many else None

    # -- stencil products ----------------------------------------------
    def halo_windows(self, x: torch.Tensor) -> torch.Tensor:
        """The 27 windows of this rank's block x (nv, l, ml, nl), its
        neighbours' halo exchanged, laid out as ``ops.stencil.windows``
        lays out the whole grid's."""
        nv, l, ml, nl = x.shape
        xp = halo_pad_shard(x, self.domain)
        self._counted(self._halo_rounds)
        w = xp.reshape(nv, -1).index_select(
            -1, _padded_index(l, ml, nl, x.device))
        return w.reshape(nv, NP, l, ml, nl).movedim(-4, -5)

    def windows(self, x: torch.Tensor) -> torch.Tensor | None:
        """:meth:`halo_windows`, for :meth:`st` to share between products
        of x; None for one rank on the card, where st's kernel reads x
        itself."""
        return None if x.is_cuda and not self._many \
            else self.halo_windows(x)

    def st(self, A: torch.Tensor, x: torch.Tensor, w=None) -> torch.Tensor:
        """The stencil product A x on this rank's block: for one rank on
        the card ``mg.Whole``'s kernel, so that one rank sweeps as the
        serial sweep does; else the plain expression over the halo
        windows (w, where another product of x took them already)."""
        if x.is_cuda and not self._many:
            return super().st(A, x)
        return stencil_hopper.apply_block_plain(
            A, x, periodic=self.periodic,
            w=self.halo_windows(x) if w is None else w)

    # -- sums over the grid --------------------------------------------
    def sum(self, t: torch.Tensor) -> torch.Tensor:
        if not self._many:
            return torch.sum(t)
        return self._allreduce(torch.sum(t)[None])[0]

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        if not self._many:
            return torch.linalg.norm(v)
        return torch.sqrt(self.sum(v * v))

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        m = torch.amax(t)
        if not self._many:
            return m
        self._counted()
        return torch.as_tensor(self.domain.amax(m), dtype=m.dtype,
                               device=m.device)

    # -- the whole grid and this block of it ---------------------------
    def shape(self, x: torch.Tensor) -> tuple[int, int]:
        return self.domain.m, self.domain.n

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (..., m, n) field of which x is this rank's block: the
        blocks placed and summed over the ranks."""
        if not self._many:
            return x
        out = x.new_zeros(x.shape[:-2] + (self.domain.m, self.domain.n))
        out[(...,) + self._block] = x
        return self._whole_sum(out)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        if not self._many:
            return x
        return x[(...,) + self._block].contiguous()

    def _owned(self, idx: tuple):
        k, j, i = idx
        if not self.domain.owns(j, i):
            return None
        return k, j - self.domain.j0, i - self.domain.i0

    def at(self, x: torch.Tensor, idx: tuple) -> torch.Tensor:
        if not self._many:
            return x[idx]
        own = self._owned(idx)
        v = x[own].reshape(1).clone() if own is not None \
            else x.new_zeros(1)
        return self._allreduce(v)[0]

    def put(self, y: torch.Tensor, idx: tuple, value) -> None:
        own = idx if not self._many else self._owned(idx)
        if own is not None:
            y[own] = value

    # -- zonal lines ---------------------------------------------------
    def _row_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., nl) blocks of this rank's row of ranks -> (..., n): each
        rank of the row sends its block to the others."""
        d = self.domain
        comm = torch.device("cpu") if d.staged else x.device
        mine = x.to(comm).contiguous()
        parts, ops = [], []
        for rx in range(d.px):
            if rx == d.rx:
                parts.append(mine)
                continue
            peer = d.grid[d.ry][rx]
            buf = torch.empty_like(mine)
            parts.append(buf)
            ops.append(dist.P2POp(dist.isend, mine, peer, d.group, tag=2))
            ops.append(dist.P2POp(dist.irecv, buf, peer, d.group, tag=2))
            d.sent_bytes += mine.numel() * mine.element_size()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self._counted()
        return torch.cat(parts, dim=-1).to(x.device)

    def xline_inv(self, An: torch.Tensor):
        """This rank's rows (nv*l*ml, nl, n) of the inverses of its lines,
        built from their bands gathered along the row of ranks, and the
        dummy rows (nv*l*ml, nl)."""
        if self.domain.px == 1:
            return super().xline_inv(An)
        xinv, dummy = _mg._xline_bands_inv(
            self._row_gather(_mg.xline_bands(An)), periodic=self.periodic)
        cols = self._block[1]
        return xinv[:, cols].contiguous(), dummy[:, cols].contiguous()

    def xline(self, xinv, xdummy, res: torch.Tensor) -> torch.Tensor:
        if self.domain.px == 1:
            return super().xline(xinv, xdummy, res)
        rx = res.reshape(-1, res.shape[-1]).masked_fill(xdummy, 0.0)
        return torch.bmm(xinv, self._row_gather(rx).unsqueeze(-1)) \
            .reshape(res.shape)

    # -- the multigrid's 2x2 aggregates --------------------------------
    def _aggregated(self, x: torch.Tensor):
        """x padded to whole aggregates: a zero row or column where the
        block starts or ends inside one (the high end of an odd global
        side pads as ``mg._pad_hv``), and the coarse cell of its first."""
        d = self.domain
        ml, nl = d.local_shape
        pads = (d.i0 % 2, (d.i0 + nl) % 2, d.j0 % 2, (d.j0 + ml) % 2)
        return F.pad(x, pads), d.j0 // 2, d.i0 // 2

    def _coarse_whole(self, c: torch.Tensor, jc: int, ic: int):
        """The whole coarse field from this rank's coarse cells c, which
        start at (jc, ic): placed, and summed over the ranks."""
        mc, nc = (self.domain.m + 1) // 2, (self.domain.n + 1) // 2
        out = c.new_zeros(c.shape[:-2] + (mc, nc))
        out[..., jc:jc + c.shape[-2], ic:ic + c.shape[-1]] = c
        return self._whole_sum(out)

    def coarsen(self, An: torch.Tensor) -> torch.Tensor:
        if not self._many:
            return super().coarsen(An)
        Ap, jc, ic = self._aggregated(An)
        return self._coarse_whole(
            _mg.coarsen_stencil(Ap, periodic=self.periodic), jc, ic)

    def restrict(self, res: torch.Tensor) -> torch.Tensor:
        if not self._many:
            return super().restrict(res)
        rp, jc, ic = self._aggregated(res)
        return self._coarse_whole(_mg._restrict(rp), jc, ic)

    def prolong(self, zc, like, w):
        return self.local(_mg._prolong2(zc, self.domain.m, self.domain.n,
                                        w, self.periodic))

    def dense(self, Ainv, r):
        rw = self.whole(r)
        return self.local((Ainv @ rw.reshape(-1)).reshape(rw.shape))



def _storages(obj, seen: dict) -> None:
    if isinstance(obj, torch.Tensor):
        s = obj.untyped_storage()
        seen[(s.data_ptr(), s.device)] = s.nbytes()
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _storages(v, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            _storages(v, seen)


def nbytes(*objs) -> int:
    """Bytes of the tensors of factor sets (NamedTuples, tuples, lists,
    dicts, tensors), each storage counted once."""
    seen = {}
    for obj in objs:
        _storages(obj, seen)
    return sum(seen.values())


def replicated_bytes(prec: bgs.BGSPrec) -> int:
    """Bytes of the pieces every rank holds whole: the 2D saddle's
    operator, point-block inverses, SIMPLE factors, Chat multigrid and
    multigrid, and the 3D multigrids' coarser levels and dense coarsest
    inverses (the finest level's, where the hierarchy has one level)."""
    whole = [prec.Spp, prec.Spp_binv, prec.spp_simple, prec.spp_mg]
    for h in (prec.ts_mg, prec.uv_mg):
        if h is not None:
            whole += [h.levels[1:], h.coarse_inv]
    return nbytes(*whole)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PartitionedBGS:
    """The BGS preconditioner of one stencil tensor on this rank's block:
    ``bgs.build`` on a :class:`PartitionedGrid` of domain (An_l is this
    rank's block, landm and int_row's coefficients whole, as for
    ``bgs.build``), cast to dtype where given; each call is one
    ``bgs.apply`` sweep of this rank's block of a vector.  Every rank of
    the domain builds and calls together.

    build_opts are bgs.build's keywords over :data:`SHARDED_BUILD` (the
    JAX package's sharded solve's build, MG on ATS); apply_opts are
    bgs.apply's, and ``check_branches`` refuses before the build what
    bgs.apply would refuse.  On CUDA and one rank the saddle iteration
    replays CUDA graphs ("graphs"), on more ranks it runs eagerly
    ("eager").  ``stats()`` gives the per-rank numbers: bytes, build
    seconds, sweeps, seconds, message rounds and whole-field bytes per
    sweep."""

    def __init__(self, An_l: torch.Tensor, landm, domain, *, int_row=None,
                 dtype=None, apply_opts: dict | None = None,
                 build_opts: dict | None = None, held=()):
        self.apply_opts = dict(apply_opts or {})
        check_branches(self.apply_opts)
        self.domain = domain
        self.grid = PartitionedGrid(domain)
        gathers = domain.gathers
        _sync(domain.device)
        t0 = time.perf_counter()
        factors = bgs.build(An_l, landm, periodic=domain.periodic,
                            int_row=int_row, grid=self.grid,
                            **dict(SHARDED_BUILD, **(build_opts or {})))
        if dtype is not None:
            factors = _to_dtype(factors, dtype)
        _sync(domain.device)
        self.build_s = time.perf_counter() - t0
        self.build_gathers = domain.gathers - gathers
        self.build_rounds = self.grid.rounds
        self.build_whole_bytes = self.grid.whole_bytes
        self.factors = factors
        self.graphs = bgs.SweepGraphs(factors) \
            if domain.device.type == "cuda" and domain.size == 1 else None
        self.held = tuple(held)
        self.sweeps = 0
        self.sweep_s = 0.0

    @property
    def path(self) -> str:
        return "graphs" if self.graphs is not None else "eager"

    def __call__(self, v_l: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        z = bgs.apply(self.factors, v_l, periodic=self.domain.periodic,
                      graphs=self.graphs, grid=self.grid, **self.apply_opts)
        _sync(self.domain.device)
        self.sweep_s += time.perf_counter() - t0
        self.sweeps += 1
        return z

    def stats(self) -> dict:
        """This rank's numbers: bytes of the stencil tensors it holds
        (``held``) and of the factor set, the bytes of the set's pieces
        held whole, build seconds, gathers (``Domain.gather``), message
        rounds and whole-field bytes summed, sweeps, and the seconds,
        message rounds and whole-field bytes per sweep, and the path of
        the saddle iteration."""
        n = max(self.sweeps, 1)
        return {"bytes": nbytes(self.held, self.factors),
                "factor_bytes": nbytes(self.factors),
                "replicated_bytes": replicated_bytes(self.factors),
                "build_s": self.build_s, "build_gathers": self.build_gathers,
                "build_rounds": self.build_rounds,
                "build_whole_bytes": self.build_whole_bytes,
                "sweeps": self.sweeps, "sweep_s": self.sweep_s / n,
                "rounds_per_sweep":
                    (self.grid.rounds - self.build_rounds) / n,
                "whole_bytes_per_sweep":
                    (self.grid.whole_bytes - self.build_whole_bytes) / n,
                "path": self.path, "ranks": self.domain.size}


def format_stats(s: dict) -> str:
    """One line of :meth:`PartitionedBGS.stats`."""
    return (f"BGS on {s['ranks']} rank(s): {s['bytes'] / 1e9:.4f} GB "
            f"(stencil and factors; factors {s['factor_bytes'] / 1e9:.4f} "
            f"GB, of them whole on every rank "
            f"{s['replicated_bytes'] / 1e9:.4f} GB), build "
            f"{s['build_s']:.3f} s with {s['build_gathers']} gathers of "
            f"the domain, {s['build_rounds']} message rounds and "
            f"{s['build_whole_bytes']} bytes of whole fields summed, "
            f"{s['sweeps']} sweeps of {s['sweep_s']:.4f} s with "
            f"{s['rounds_per_sweep']:.1f} message rounds and "
            f"{s['whole_bytes_per_sweep']:.0f} bytes of whole fields summed "
            f"each, saddle iteration {s['path']}")
