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
``fold_in(PRNGKey(base_seed), i)``, the JAX package's streams.

Over a mesh of ranks along ``"batch"`` (``mesh.make_mesh(axis_names=
("batch",))``, one card a rank) the replica axis is split: rank r runs the
contiguous replicas ``[r·B/W, (r+1)·B/W)`` (:func:`shard_batch`) through the
same batched superstep, with no collective inside a superstep, and
:func:`gather_batch` makes the batch whole again in rank order.  Replica
``r·B/W + i`` keeps its key ``fold_in(PRNGKey(base_seed), r·B/W + i)``, so it
is the one-process batch's replica bit for bit.

On a 2-D ``("batch", "sites")`` mesh the replicas split along ``"batch"``
and each replica's sites along ``"sites"`` (the replicated decomposition,
``parallel.sharding``): the ranks of one ``"sites"`` line hold the same
replicas and run each through the line's sharded superstep, as XLA runs
``P("batch")`` states against a ``P("sites")`` geometry under one jit in the
JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..state import (Geometry, PhysParams, SimState, batch_size, replace, stack_states,
                     unbatch_all)
from ..superstep import SuperstepGraph, graph_ready, superstep_batched


def batch_states(state: SimState, n: int, base_seed: int = 0) -> SimState:
    """Replicate a single state ``n`` times with independent random streams:
    replica i gets ``fold_in(PRNGKey(base_seed), i)``."""
    base = rng.prng_key(base_seed)
    batched = stack_states([state] * n)
    return dataclasses.replace(batched, key=rng.keys_tensor(
        [rng.fold_in(base, i) for i in range(n)], batched.element.device))


def make_batched_superstep(geom: Geometry, params: PhysParams, heat, mesh=None,
                           axis: str = "batch"):
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
    ``superstep.superstep_batched`` eagerly.

    ``mesh`` (a mesh along ``axis``): each rank calls the superstep with its
    replicas (:func:`shard_batch`) on the mesh's device, as the JAX package
    shards the batch axis (``devicekmc_tpu/parallel/batched.py:40-64``);
    the replicas are independent, so no collective runs.  On a 2-D
    ``("batch", "sites")`` mesh ``geom`` is ``sharding.shard_simulation``'s
    (this rank's rows along ``"sites"``), and each call runs the rank's
    replicas one by one, eagerly, through ``sharding.make_sharded_superstep``
    on the mesh's ``"sites"`` view (:func:`_replica_by_replica`)."""
    if mesh is not None:
        mesh.axis(axis)
        if geom.device != mesh.device:
            raise ValueError(f"the geometry is on {geom.device}, the mesh's device is "
                             f"{mesh.device}")
        if len(mesh.axis_names) == 2:
            if axis != "batch":
                raise ValueError(f"a 2-D mesh splits the replicas along 'batch', not {axis!r}")
            from .sharding import make_sharded_superstep

            return _replica_by_replica(geom, make_sharded_superstep(geom, params, heat, mesh))

    # B is known only at the call: a batch of None is the case B > 1, which
    # with solve_current runs eagerly, replica by replica
    if graph_ready(params, batch=None) is None:
        graphs = {}

        def superstep(states: SimState, Vd: float):
            B = batch_size(states)
            if B not in graphs:
                graphs[B] = SuperstepGraph(geom, params, B, heat=heat)
            return graphs[B].step_batched(states, Vd)

        superstep.graphs = graphs
        return superstep

    def superstep(states: SimState, Vd: float):
        return superstep_batched(geom, params, states, Vd, heat=heat)

    return superstep


def _replica_by_replica(geom: Geometry, step):
    """``superstep(states, Vd)`` over a batched state that runs ``step``
    (a single state's superstep) on each replica in turn and stacks the
    results: the step times [B] float64 and every metric a [B] float64
    tensor."""
    def superstep(states: SimState, Vd: float):
        singles, dts, rows = [], [], []
        for st in unbatch_all(states):
            st, dt, m = step(st, Vd)
            singles.append(st)
            dts.append(float(dt))
            rows.append(m)
        f64 = dict(dtype=torch.float64, device=geom.device)
        metrics = {k: torch.tensor([float(m[k]) for m in rows], **f64) for k in rows[0]}
        return stack_states(singles), torch.tensor(dts, **f64), metrics

    return superstep


def _split(mesh, B: int, axis: str):
    mesh = mesh.axis(axis)
    if B % mesh.world:
        raise ValueError(f"{B} replicas do not split over {mesh.world} ranks")
    per = B // mesh.world
    return mesh.rank * per, per


def shard_batch(states: SimState, mesh, axis: str = "batch") -> SimState:
    """This rank's contiguous ``B / W`` replicas ``[r·B/W, (r+1)·B/W)`` of
    the batched state ``states`` (copies on the mesh's device), for a mesh of
    W ranks along ``axis`` (r: this rank's coordinate along it).  Raises
    ValueError when W does not divide B."""
    lo, per = _split(mesh, batch_size(states), axis)
    return replace(states, **{f: v[lo:lo + per].to(mesh.device, copy=True)
                              for f, v in vars(states).items()})


def gather_batch(states: SimState, mesh) -> SimState:
    """The whole batch from every rank's replicas (:func:`shard_batch`'s
    layout), in rank order, on every rank: one all-gather a field, a
    collective that every rank calls (the counterpart of reading a sharded
    JAX array); on a 2-D mesh over the ranks of this rank's ``"batch"``
    line."""
    comm = mesh.axis("batch").comm
    return replace(states, **{f: comm.all_gather(v) for f, v in vars(states).items()})
