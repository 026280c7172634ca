"""Batched device ensembles: B independent replicas of one device through
one superstep, the port of ``devicekmc_tpu/parallel/batched.py``.

The crossbar structures are arrays of nominally identical devices.  Instead
of one merged structure, B replicas of one geometry, each with its own state
and random stream, run through one superstep with a replica axis
(``superstep.superstep_batched``): one launch of each kernel of the headline
path for all replicas, so that one card runs a whole ensemble for
device-to-device variability and ensemble statistics.  Replica b computes
exactly what a single run from its state and key computes.

A batched state is a ``SimState`` with a leading replica axis
(``state.stack_states``, ``state.unbatch``); replica i's key is
``fold_in(PRNGKey(base_seed), i)``, the JAX package's streams.  Sharding the
replica axis over a mesh of cards (``mesh``, :func:`shard_batch`) is not
ported (ROADMAP §1 item 5.3).
"""

from __future__ import annotations

import dataclasses

from .. import rng
from ..state import Geometry, PhysParams, SimState, batch_size, stack_states
from ..superstep import SuperstepGraph, graph_ready, superstep_batched

_NO_MESH = ("sharding the replica axis over a mesh of cards is not ported yet "
            "(ROADMAP §1 item 5.3: make_batched_superstep's mesh= and shard_batch)")


def batch_states(state: SimState, n: int, base_seed: int = 0) -> SimState:
    """Replicate a single state ``n`` times with independent random streams:
    replica i gets ``fold_in(PRNGKey(base_seed), i)``."""
    base = rng.prng_key(base_seed)
    batched = stack_states([state] * n)
    return dataclasses.replace(batched, key=rng.keys_tensor(
        [rng.fold_in(base, i) for i in range(n)], batched.element.device))


def make_batched_superstep(geom: Geometry, params: PhysParams, heat, mesh=None):
    """Return ``superstep(states, Vd) -> (states, step_times, metrics)`` over
    the leading replica axis of a batched state: ``step_times`` [B] and every
    metric a [B] tensor (``n_events``, ``n_active_rows``,
    ``n_charged_sites``, ``cg_iters_boundary``, ``boundary_converged``, and
    those of the transport and heat phases when they run).  ``heat``: the
    heat model of the single path (``physics.heat``).

    The configurations of ``superstep.graph_ready`` (the headline module set)
    run each call as one replay of the superstep's captured CUDA graph at
    that B (``superstep.SuperstepGraph.step_batched``; on the CPU its plain
    version), as the JAX package jits its vmap
    (``devicekmc_tpu/parallel/batched.py:47-51``), and read nothing back; the
    returned tensors are copies of the graph's outputs (the function's
    ``graphs``: its ``SuperstepGraph`` by B).  The others run
    ``superstep.superstep_batched`` eagerly."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)

    # B is known only at the call: a batch of None is the case B > 1, which
    # with solve_current runs eagerly, replica by replica
    if graph_ready(params, batch=None) is None:
        graphs = {}

        def superstep(states: SimState, Vd: float):
            B = batch_size(states)
            if B not in graphs:
                graphs[B] = SuperstepGraph(geom, params, B)
            return graphs[B].step_batched(states, Vd)

        superstep.graphs = graphs
        return superstep

    def superstep(states: SimState, Vd: float):
        return superstep_batched(geom, params, states, Vd, heat=heat)

    return superstep


def shard_batch(states: SimState, mesh) -> SimState:
    """Not ported: the replica axis runs on one card."""
    raise NotImplementedError(_NO_MESH)
