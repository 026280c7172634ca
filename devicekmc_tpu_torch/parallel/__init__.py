"""Parallel layouts of the port.  ``batched``: B replicas of one device as a
batch axis on one card.  ``mesh``, ``multihost``, ``halo``,
``halo_superstep`` and ``halo_transport``: one structure split into x-slabs
over the ranks of a ``torch.distributed`` process group, one card (or CPU) a
rank, with halo exchanges between neighbouring slabs, and the blocked
transport operator split over the ranks by rows.  The replicated
decomposition of the JAX package (``devicekmc_tpu/parallel/sharding.py``) is
not ported yet (ROADMAP §1 item 5)."""

from . import multihost
from .batched import batch_states, make_batched_superstep, shard_batch
from .halo import compute_halo_width, make_halo_laplace_solver
from .mesh import Communicator, Mesh, make_mesh

__all__ = ["batch_states", "make_batched_superstep", "shard_batch", "multihost",
           "compute_halo_width", "make_halo_laplace_solver", "Communicator", "Mesh",
           "make_mesh"]
