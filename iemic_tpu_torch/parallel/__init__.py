"""Domain decomposition over torch.distributed (the TRIOS::Domain analog).

Port of ``iemic_tpu/parallel``.  The reference parallelizes by a 2D
processor grid over (lon, lat) with 2-deep ghost layers and Epetra
Import/Export halo transfers (reference src/trios/TRIOS_Domain.H:29-99,
:342-348).  Here the same strategy runs one process per rank, each with
its block on its own device: a ``Domain`` lays the ranks on the (py, px)
grid, and the stencil matvec exchanges explicit halos between neighbours
with ``torch.distributed`` point-to-point messages (periodic wraparound in
x included, reference TRIOS_Domain.H:337-340).  The residual and the
Jacobian are assembled on each block extended by a 2-deep halo
(``assembly``), the block Gauss-Seidel preconditioner is factored and
applied on each block (``bgs``), every other method of the solver factory
has its sharded preconditioner (``methods``: Amesos and MILU on the
matrix gathered to rank 0), and ``ShardedOcean`` runs a continuation on
the split state.
"""

from .domain import Domain, decomp2d
from .halo import (halo_extend, halo_pad_shard, make_sharded_stencil_apply,
                   make_sharded_ops, make_sharded_solve)
from .model import ShardedOcean

__all__ = ["Domain", "decomp2d", "halo_extend", "halo_pad_shard",
           "make_sharded_stencil_apply", "make_sharded_ops",
           "make_sharded_solve", "ShardedOcean"]
