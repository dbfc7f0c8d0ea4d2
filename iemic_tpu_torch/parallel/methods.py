"""The sharded solve's preconditioners, one for each method of
``solvers.factory.make_preconditioner``, on the ranks of a Domain.

The JAX package's sharded solve is ``Ocean.solve`` on a sharded state
under GSPMD, so it runs every method the factory builds.  Here each
method is built and applied on this rank's block of the row-scaled
stencil tensor by hand (:func:`make_preconditioner`), and the sharded
solve's Double, Mixed and Host loops (:mod:`.halo`) take any of them:

  * None: the identity.
  * Columns: the inverses of the rank's water columns (z is never
    partitioned, so a column lies on one rank); no message.
  * BGS: :class:`.bgs.PartitionedBGS`, factored and applied on the block.
  * Teko: the group inverses Minv_X (u, v, w, p, with the pressure shift)
    and Minv_Y (T, S) are column blocks, local to the rank; the coupling
    products C_XY z_Y (and C_YX z_X from the second sweep on) are stencil
    products of 4x2 and 2x4 variable sub-tensors, each taking the 1-deep
    halo of :class:`.bgs.PartitionedGrid` (``rearranger.apply`` with
    ``grid=``).
  * Amesos and MILU: a sparse LU and the multilevel ILU of the assembled
    CSR matrix, whose factors need the whole matrix.  These two methods,
    and only these, gather: the row-scaled stencil tensor to rank 0 once
    per Jacobian (``Domain.gather_to``), where the factory's own build
    factors it; each application gathers the residual to rank 0, solves
    there on the host and scatters the blocks back
    (``Domain.scatter_from``): two message rounds.  The other ranks hold
    no factor, and no rank but rank 0 holds the whole tensor.  On one
    rank there is no collective.

None, Columns, BGS and Teko gather nothing, in the build or in an
application.  With a dtype the factors are built in f64 and cast (the
Mixed solve's, as ``Ocean`` casts them); the host methods take none,
their solve being the f64 one whatever Precision says.  Every
preconditioner counts, on this rank, its build's seconds, gathers and
message rounds, and its applications' (``stats()``).
"""

from __future__ import annotations

import time

import torch

from ..config import ParameterList
from ..models.ocean.ocean import _to_dtype
from ..solvers import factory, rearranger
from ..solvers.preconditioner import apply_column_prec, build_column_blocks
from .bgs import PartitionedBGS, PartitionedGrid, check_branches, int_row_of
from .bgs import nbytes, _sync

ROOT = 0


class Sharded:
    """One method's preconditioner of one stencil tensor on this rank:
    ``factors`` from build(), each call one application of this rank's
    block of a vector.  Counts, on this rank, the build's seconds,
    gathers (``Domain.gathers``) and message rounds, and per application
    the seconds, message rounds and gathers, and the bytes of the global
    tensors gathered to one rank (``Domain.gathered_bytes``)."""

    method = ""

    def __init__(self, domain, build):
        self.domain = domain
        before = self._counts()
        _sync(domain.device)
        t0 = time.perf_counter()
        self.factors = build()
        _sync(domain.device)
        self.build_s = time.perf_counter() - t0
        self.build_counts = [a - b for a, b in zip(self._counts(), before)]
        self.applications = 0
        self.apply_s = 0.0
        self.apply_counts = [0, 0, 0]

    def rounds(self) -> int:
        """Message rounds so far."""
        return 0

    def _counts(self) -> tuple[int, int, int]:
        d = self.domain
        return self.rounds(), d.gathers, d.gathered_bytes

    def apply(self, v_l: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, v_l: torch.Tensor) -> torch.Tensor:
        before = self._counts()
        t0 = time.perf_counter()
        z = self.apply(v_l)
        _sync(self.domain.device)
        self.apply_s += time.perf_counter() - t0
        self.applications += 1
        for k, (a, b) in enumerate(zip(self._counts(), before)):
            self.apply_counts[k] += a - b
        return z

    def stats(self) -> dict:
        """This rank's numbers: the method, the ranks, the bytes of the
        factors this rank holds, build seconds, gathers, message rounds
        and gathered bytes, applications, and the seconds, message rounds,
        gathers and gathered bytes per application."""
        n = max(self.applications, 1)
        (b_rounds, b_gathers, b_bytes), (a_rounds, a_gathers, a_bytes) = \
            self.build_counts, self.apply_counts
        return {"method": self.method, "ranks": self.domain.size,
                "factor_bytes": nbytes(self.factors),
                "build_s": self.build_s, "build_gathers": b_gathers,
                "build_rounds": b_rounds, "build_gathered_bytes": b_bytes,
                "applications": self.applications,
                "apply_s": self.apply_s / n,
                "rounds_per_apply": a_rounds / n,
                "gathers_per_apply": a_gathers / n,
                "gathered_bytes_per_apply": a_bytes / n}


class Identity(Sharded):
    method = "None"

    def __init__(self, domain):
        super().__init__(domain, lambda: None)

    def apply(self, v_l):
        return v_l


class PartitionedColumns(Sharded):
    """The column-block inverses of this rank's block."""
    method = "Columns"

    def __init__(self, An_s, domain, dtype=None):
        super().__init__(domain, lambda: _cast(build_column_blocks(An_s),
                                               dtype))

    def apply(self, v_l):
        return apply_column_prec(self.factors, v_l)


class PartitionedTeko(Sharded):
    """``rearranger.build`` of this rank's block, and ``rearranger.apply``
    with its coupling products on a :class:`.bgs.PartitionedGrid`: one
    halo exchange per product, 2*sweeps - 1 a sweep."""
    method = "Teko"

    def __init__(self, An_s, domain, dtype=None, sweeps: int = 1):
        self.grid = PartitionedGrid(domain)
        self.sweeps = int(sweeps)
        super().__init__(domain, lambda: _cast(rearranger.build(
            An_s, periodic=domain.periodic), dtype))

    def rounds(self):
        return self.grid.rounds

    def apply(self, v_l):
        return rearranger.apply(self.factors, v_l,
                                periodic=self.domain.periodic,
                                sweeps=self.sweeps, grid=self.grid)


class RootFactor(Sharded):
    """A host-side method (Amesos, MILU) of the factory: the whole
    row-scaled tensor gathered to rank 0 and factored there by the
    factory's build; an application gathers the residual to rank 0,
    solves there and scatters the blocks back.  The other ranks hold no
    factor (``factors`` None).  On one rank no collective: the factory's
    build and apply of the block, which is the whole tensor."""

    def __init__(self, An_s, domain, params: ParameterList):
        self.method = params.get("Method")
        self._build, self._apply = factory.make_preconditioner(
            params, landm=None, periodic=domain.periodic,
            grid_shape=(domain.l, domain.m, domain.n))
        self._many = domain.size > 1
        self._rounds = 0

        def build():
            An = self._gather(An_s) if self._many else An_s
            return None if An is None else self._build(An)

        super().__init__(domain, build)

    def rounds(self):
        return self._rounds

    def _gather(self, x_l):
        self._rounds += 1
        return self.domain.gather_to(x_l, ROOT)

    def apply(self, v_l):
        if not self._many:
            return self._apply(self.factors, v_l)
        v = self._gather(v_l)
        z = None if v is None else self._apply(self.factors, v)
        self._rounds += 1
        return self.domain.scatter_from(z, v_l, ROOT)


def _cast(factors, dtype):
    return factors if dtype is None else _to_dtype(factors, dtype)


def make_preconditioner(ocean, domain, method: str, params=None, *,
                        apply_opts: dict | None = None,
                        build_opts: dict | None = None):
    """``make(An_s, rint, dtype=None, held=()) -> preconditioner``: this
    rank's preconditioner of method for its block An_s of the (row-scaled)
    stencil tensor, whose integral-condition row is scaled by rint, its
    factors cast to dtype where given; held are the stencil tensors
    ``PartitionedBGS`` counts beside its factors.  params is the
    Preconditioner list ("Teko sweeps", the MILU knobs); the BGS factors
    are ``bgs.build``'s with build_opts over :data:`.bgs.SHARDED_BUILD`,
    its sweep ``bgs.apply``'s with apply_opts.  Raises the factory's
    ValueError for a method it does not know, and what ``bgs.apply``
    refuses of apply_opts, before any build."""
    factory.check_method(method)
    plist = factory.preconditioner_params(dict(
        params.to_dict() if isinstance(params, ParameterList)
        else params or {}, Method=method))
    apply_kw = dict(apply_opts or {})
    if method == "BGS":
        check_branches(apply_kw)

    def make(An_s, rint, dtype=None, held=()):
        if method == "None":
            return Identity(domain)
        if method == "Columns":
            return PartitionedColumns(An_s, domain, dtype)
        if method == "Teko":
            return PartitionedTeko(An_s, domain, dtype,
                                   plist.get("Teko sweeps"))
        if method in factory.HOST_METHODS:
            return RootFactor(An_s, domain, plist)
        return PartitionedBGS(
            An_s, ocean.landm, domain,
            int_row=int_row_of(ocean, rint * ocean.cfg.int_sign),
            dtype=dtype, apply_opts=apply_kw, build_opts=build_opts,
            held=held)

    return make


def format_stats(s: dict) -> str:
    """One line of :meth:`Sharded.stats`."""
    return (f"{s['method']} on {s['ranks']} rank(s): factors "
            f"{s['factor_bytes']} bytes, build {s['build_s']:.3f} s with "
            f"{s['build_gathers']} gathers ({s['build_gathered_bytes']} "
            f"bytes gathered) and {s['build_rounds']} message rounds, "
            f"{s['applications']} applications of {s['apply_s']:.4f} s with "
            f"{s['rounds_per_apply']:.1f} message rounds, "
            f"{s['gathers_per_apply']:.1f} gathers and "
            f"{s['gathered_bytes_per_apply']:.0f} bytes gathered each")
