"""Multi-process environment over torch.distributed.

Port of ``iemic_tpu/parallel/multihost.py`` (the reference's MPI
environment setup, src/globaldefs/GlobalDefinitions.C:88+
``initializeEnvironment``: MPI_Init, per-rank info streams, rank-0
cdata/tdata files; and the host-spanning communicator Epetra wraps,
TRIOS_Domain.H:11-15).

Where JAX runs one process per host and one program over every device,
the port runs one process per rank, each holding one block of the domain
on one device; ``initialize_environment`` wires the processes into a
``torch.distributed`` process group.  The backend is always the caller's
choice: NCCL takes one rank per card, gloo any number of ranks on one
card or on the CPU (``parallel.domain.Domain`` refuses two NCCL ranks on
one device).

The layout rule is the JAX package's: the outer (y) axis of the
decomposition spans nodes, so that whole latitude bands sit on each node
and halo exchange crosses the slow link only at band boundaries.
``host_spanning_device_array`` and ``decomp2d_multihost`` are that pure
layout logic, copied; their "devices" are rank descriptors with a
``process_index`` (the node) and an ``id`` (the rank).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch.distributed as dist


def initialize_environment(backend: str, init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           timeout_s: float = 600.0) -> int:
    """Join the process group (idempotent); returns this process's rank.

    The analog of ``initializeEnvironment`` (GlobalDefinitions.C:88+):
    with no init_method, no world_size and no cluster environment
    (``WORLD_SIZE`` above 1, as torchrun sets) this is a no-op
    single-process set-up.  timeout_s bounds every collective, so that
    the ranks of a run whose rank failed stop waiting on it."""
    want = (init_method is not None or world_size is not None
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if want and not dist.is_initialized():
        kw = {} if init_method is None else {"init_method": init_method}
        dist.init_process_group(
            backend, world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return process_index()


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_primary() -> bool:
    """True on the I/O process (the reference writes cdata.txt and the
    HDF5 checkpoints from rank 0 only; info_<rank>.txt per rank)."""
    return process_index() == 0


# Copied from iemic_tpu/parallel/multihost.py (pure layout logic; importing
# iemic_tpu would import jax).
def host_spanning_device_array(devices, py: int, px: int) -> np.ndarray:
    """Arrange ``devices`` (from every process) into a (py, px) array
    whose *rows* group by process: the y axis spans hosts (DCN), the x
    axis stays within a host (ICI).

    Pure layout logic (no jax calls) so it can be unit-tested with a
    mocked device list; ``Domain`` wraps the result in a Mesh.
    """
    devices = list(devices)
    if py * px != len(devices):
        raise ValueError(f"mesh {py}x{px} != {len(devices)} devices")
    # stable sort by (process, id): contiguous per-process blocks
    devices.sort(key=lambda d: (getattr(d, "process_index", 0),
                                getattr(d, "id", 0)))
    procs = [getattr(d, "process_index", 0) for d in devices]
    nproc = len(set(procs))
    arr = np.asarray(devices, dtype=object).reshape(py, px)
    if nproc > 1:
        # validate: no row mixes processes unless a process owns
        # multiple full rows' worth of devices
        per_proc = len(devices) // nproc
        if per_proc % px != 0 and px % per_proc != 0:
            raise ValueError(
                f"cannot span {nproc} hosts with {per_proc} devices "
                f"each over a {py}x{px} mesh without splitting a halo "
                f"row across DCN; choose px | devices-per-host")
    return arr


# Copied from iemic_tpu/parallel/multihost.py (pure layout logic).
def decomp2d_multihost(devices, n: int, m: int) -> tuple[int, int]:
    """Pick (py, px) for a host-spanning mesh: like
    :func:`.domain.decomp2d` but constrained so each host owns whole
    latitude bands (px divides the per-host device count), keeping all
    x-periodic wraparound traffic on ICI."""
    devices = list(devices)
    nd = len(devices)
    procs = {getattr(d, "process_index", 0) for d in devices}
    nproc = len(procs)
    per_proc = nd // max(nproc, 1)
    best = None
    for py in range(1, nd + 1):
        if nd % py:
            continue
        px = nd // py
        if m % py or n % px:
            continue
        if nproc > 1 and per_proc % px != 0:
            continue     # a halo row would straddle DCN
        cost = n / px + m / py
        if best is None or cost < best[0]:
            best = (cost, py, px)
    if best is None:
        raise ValueError(
            f"cannot decompose grid {n}x{m} over {nd} devices on "
            f"{nproc} hosts")
    return best[1], best[2]
