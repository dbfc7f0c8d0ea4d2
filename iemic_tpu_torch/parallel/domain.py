"""2D spatial domain decomposition over torch.distributed ranks.

Port of ``iemic_tpu/parallel/domain.py``, the analog of
``TRIOS::Domain`` (reference src/trios/TRIOS_Domain.H:39-379):

  * ``decomp2d`` — pick the processor-grid shape (py, px), the analog of
    Decomp2D (reference TRIOS_Domain.C Decomp2D), minimizing halo surface
    subject to divisibility (copied).
  * ``Domain`` — lays the ranks of a process group row-major on the
    (py, px) grid (y rows grouped by node, ``multihost``), records each
    rank's place (ry, rx) and its four neighbours, and places tensors:
       - state     (nun, l, m, n)          split over (m -> y, n -> x)
       - stencil   (27, nun, nun, l, m, n) likewise
       - surface   (m, n)
       - replicated (anything small, whole on every rank)

Where the JAX package places global arrays on a device mesh and lets
GSPMD partition jitted code, each rank here holds its own block on its
own device, and every exchange is an explicit collective: the halo swap
of :mod:`.halo`, the sum over ranks (``allreduce``) and the gather of a
sharded tensor (``gather``).  Torch has no GSPMD, so the JAX package's
``constrain_state`` (a sharding constraint inside jitted code) has no
counterpart.

Under gloo, CUDA tensors cross between ranks through host buffers: the
choice follows from the backend, never from an error.  NCCL takes them
from the card, one rank per card.

z is never partitioned, exactly like the reference (z-integrals stay
local, TRIOS_Domain.H:63-84).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .multihost import decomp2d_multihost, host_spanning_device_array


# Copied from iemic_tpu/parallel/domain.py (pure Python).
def decomp2d(n_devices: int, n: int, m: int) -> tuple[int, int]:
    """Pick (py, px) with py*px == n_devices, py | m, px | n, minimizing
    the halo perimeter per shard (n/px + m/py).

    Analog of the reference's Decomp2D processor-grid factorization
    (reference src/trios/TRIOS_Domain.C, Decomp2D).
    """
    best = None
    for py in range(1, n_devices + 1):
        if n_devices % py:
            continue
        px = n_devices // py
        if m % py or n % px:
            continue
        cost = n / px + m / py
        if best is None or cost < best[0]:
            best = (cost, py, px)
    if best is None:
        raise ValueError(
            f"cannot decompose grid {n}x{m} over {n_devices} devices: "
            "no factorization py*px with py|m and px|n exists")
    return best[1], best[2]


@dataclass(frozen=True)
class RankInfo:
    """Where a rank runs: ``process_index`` is its node, ``id`` its rank
    in the group (the descriptor ``multihost``'s layout functions take)."""
    process_index: int
    id: int
    device: str


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: the CPU when asked for, else
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` where a launcher
    sets it, else the rank), or the CUDA device named."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("Domain: device cuda but no CUDA device (pass "
                           "device=\"cpu\" to run on the CPU)")
    if device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


class Domain:
    """The (py, px) rank grid of a (nun, l, m, n) grid, for one rank.

    group is the process group (the default group when None; a single
    rank without any process group).  Every rank of the group owns one
    block, so py * px must equal the group's size."""

    def __init__(self, n: int, m: int, l: int, *, periodic: bool = False,
                 shape: tuple[int, int] | None = None, group=None,
                 device="cuda"):
        self.group = group
        if dist.is_available() and dist.is_initialized():
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        else:
            self.rank, self.size, self.backend = 0, 1, None
        self.device = rank_device(device, self.rank)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)
        # gloo moves CUDA tensors through the host (see the module note)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

        ranks = self._rank_infos()
        nodes = {r.process_index for r in ranks}
        if self.backend == "nccl":
            seen = {}
            for r in ranks:
                key = (r.process_index, r.device)
                if key in seen:
                    raise ValueError(
                        f"Domain: NCCL ranks {seen[key]} and {r.id} share "
                        f"device {r.device}; NCCL takes one rank per card "
                        "(run more ranks on one card over gloo)")
                seen[key] = r.id
        if shape is None:
            shape = (decomp2d_multihost(ranks, n, m) if len(nodes) > 1
                     else decomp2d(self.size, n, m))
        py, px = shape
        if py * px != self.size:
            raise ValueError(f"grid of ranks {py}x{px} needs {py * px} "
                             f"ranks, the group has {self.size}")
        if m % py or n % px:
            raise ValueError(f"grid {n}x{m} not divisible by rank grid "
                             f"{px}x{py}")
        self.n, self.m, self.l = n, m, l
        self.periodic = periodic
        self.py, self.px = py, px

        # ranks row-major on the grid, whole rows on one node
        layout = host_spanning_device_array(ranks, py, px)
        self.grid = [[self._global(r.id) for r in row] for row in layout]
        self.ry, self.rx = next((y, x) for y in range(py) for x in range(px)
                                if layout[y][x].id == self.rank)
        ml, nl = self.local_shape
        self.j0, self.i0 = self.ry * ml, self.rx * nl
        ry, rx = self.ry, self.rx
        # neighbours (global ranks) below and above in y, left and right
        # in x; None at a wall
        self.south = self.grid[ry - 1][rx] if ry > 0 else None
        self.north = self.grid[ry + 1][rx] if ry < py - 1 else None
        wrap = periodic and px > 1
        self.west = (self.grid[ry][(rx - 1) % px]
                     if rx > 0 or wrap else None)
        self.east = (self.grid[ry][(rx + 1) % px]
                     if rx < px - 1 or wrap else None)
        # bytes this rank has sent in halo exchanges
        self.sent_bytes = 0

    def _global(self, group_rank: int) -> int:
        if self.group is None or self.size == 1:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def _rank_infos(self) -> list[RankInfo]:
        """(node, rank, device) of every rank of the group; the node is the
        index of the rank's host name among the group's hosts."""
        mine = (socket.gethostname(), str(self.device))
        if self.size == 1:
            every = [mine]
        else:
            group = self.group
            if self.backend == "nccl":
                # NCCL fails on ranks that share a card before the check
                # below could say why: gather over a gloo group instead
                group = dist.new_group(
                    None if group is None
                    else dist.get_process_group_ranks(group), backend="gloo")
            every = [None] * self.size
            dist.all_gather_object(every, mine, group=group)
        hosts = sorted({h for h, _ in every})
        return [RankInfo(hosts.index(h), r, d)
                for r, (h, d) in enumerate(every)]

    # -- placement helpers (the Import/Export analogs) -----------------
    def _block(self, x: torch.Tensor) -> torch.Tensor:
        ml, nl = self.local_shape
        return x[..., self.j0:self.j0 + ml, self.i0:self.i0 + nl] \
            .to(self.device).contiguous()

    def shard_state(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a (nun, l, m, n) state (Standard map)."""
        return self._block(x)

    def shard_stencil(self, An: torch.Tensor) -> torch.Tensor:
        """This rank's block of a (27, nun, nun, l, m, n) stencil tensor."""
        return self._block(An)

    def shard_surface(self, f: torch.Tensor) -> torch.Tensor:
        """This rank's block of an (m, n) surface field (surface map,
        reference TRIOS_Domain.H:188-201)."""
        return self._block(f)

    def replicate(self, v: torch.Tensor) -> torch.Tensor:
        """The whole of v on this rank's device (the reference's
        replicated ColMap, Utils.H:352-391)."""
        return v.to(self.device)

    # -- collectives ---------------------------------------------------
    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks, on every rank (in place where t
        is contiguous and on the device the backend takes)."""
        if self.size == 1:
            return t
        if self.staged:
            h = t.cpu()
            dist.all_reduce(h, group=self.group)
            return h.to(self.device)
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t

    @property
    def reduce(self):
        """The sum over ranks for ``fgmres_flat``/``fgmres_host``'s
        ``reduce``: None on one rank, whose solve then runs the serial
        arithmetic."""
        return self.allreduce if self.size > 1 else None

    def norm(self, v: torch.Tensor) -> float:
        """The 2-norm of a vector whose blocks the ranks hold."""
        v = v.reshape(-1)
        if self.size == 1:
            return float(torch.linalg.norm(v))
        return float(torch.sqrt(self.allreduce(torch.dot(v, v)[None])[0]))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global (..., m, n) tensor from every rank's (..., ml, nl)
        block, on every rank (the reference's Utils::AllGather,
        Utils.H:352-391)."""
        if self.size == 1:
            return x.clone()
        comm = torch.device("cpu") if self.staged else self.device
        x = x.to(comm).contiguous()
        blocks = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(blocks, x, group=self.group)
        ml, nl = self.local_shape
        out = torch.empty(x.shape[:-2] + (self.m, self.n), dtype=x.dtype,
                          device=comm)
        for y, row in enumerate(self.grid):
            for xx, r in enumerate(row):
                g = r if self.group is None else \
                    dist.get_group_rank(self.group, r)
                out[..., y * ml:(y + 1) * ml, xx * nl:(xx + 1) * nl] = \
                    blocks[g]
        return out.to(self.device)

    def owns(self, j: int, i: int) -> bool:
        """Whether the global cell (j, i) lies in this rank's block."""
        ml, nl = self.local_shape
        return (self.j0 <= j < self.j0 + ml) and (self.i0 <= i < self.i0 + nl)

    @property
    def local_shape(self) -> tuple[int, int]:
        """(m_loc, n_loc) per-rank block size (the Standard map's local
        elements)."""
        return self.m // self.py, self.n // self.px

    def __repr__(self):
        return (f"Domain(grid {self.n}x{self.m}x{self.l}, ranks "
                f"{self.py}x{self.px}, periodic={self.periodic})")
