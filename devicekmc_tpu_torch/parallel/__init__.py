"""Parallel layouts of the port.  ``batched``: B replicas of one device as a
batch axis on one card.  The mesh, sharding, halo and multi-host layers of
the JAX package (``devicekmc_tpu/parallel``) are not ported yet (ROADMAP §1
item 6)."""

from .batched import batch_states, make_batched_superstep, shard_batch

__all__ = ["batch_states", "make_batched_superstep", "shard_batch"]
