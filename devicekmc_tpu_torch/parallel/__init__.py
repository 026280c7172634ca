"""Parallel layouts of the port.  ``batched``: B replicas of one device as a
batch axis on one card, or split over the ranks of a mesh along
``"batch"``.  ``mesh``, ``multihost``: the ranks of a ``torch.distributed``
process group, one card (or CPU) a rank.  ``sharding``: one structure's
state whole on every rank, the phases that read pair arrays split over the
ranks by site rows (the replicated decomposition, what
``Simulation(mesh=...)`` runs by default).  ``halo``, ``halo_superstep``
and ``halo_transport``: one structure split into x-slabs over the ranks,
with halo exchanges between neighbouring slabs, and the blocked transport
operator split over the ranks by rows."""

from . import multihost
from .batched import batch_states, gather_batch, make_batched_superstep, shard_batch
from .halo import compute_halo_width, make_halo_laplace_solver
from .mesh import Communicator, Mesh, make_mesh
from .sharding import make_sharded_superstep, shard_simulation, solve_cb_edge_sharded

__all__ = ["batch_states", "gather_batch", "make_batched_superstep", "shard_batch",
           "multihost", "compute_halo_width", "make_halo_laplace_solver", "Communicator",
           "Mesh", "make_mesh", "make_sharded_superstep", "shard_simulation",
           "solve_cb_edge_sharded"]
