"""The mesh of the port's multi-card layers: one process a card, over
``torch.distributed``, the port of ``devicekmc_tpu/parallel/mesh.py``.

The JAX package's mesh is an array of devices that one program drives,
along ``"sites"``, ``"batch"`` or both.  Here each rank is a process that
drives its own card (NCCL) or its own CPU (gloo), and :class:`Mesh` holds
what a rank needs to know of the others: the process group, its rank, the
world size, its device, the mesh's axes and shape, and for a 2-D
``("batch", "sites")`` mesh the 1-D view of each axis (:meth:`Mesh.axis`,
over a sub-group).  :class:`Communicator` carries the collectives of the
halo and replicated paths (the neighbour exchange, sums and gathers) and
counts its calls by kind.

A world of one rank needs no launcher: :func:`make_mesh` then starts a
one-process group itself.  A larger world is started by ``torchrun``
(``multihost.initialize``) or by the caller's ``init_process_group``.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

#: the backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

#: how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _all_gather_single():
    # torch 2.13 renames all_gather_into_tensor (kept there, deprecated)
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


#: dtypes a collective carries as another of the same width (gloo has no
#: bool or uint32 gathers)
_CARRIED = {torch.bool: torch.uint8, torch.uint32: torch.int32}


def _carried(t: torch.Tensor) -> torch.Tensor:
    c = _CARRIED.get(t.dtype)
    if c is None:
        return t
    return t.to(c) if t.dtype == torch.bool else t.view(c)


def _restored(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if t.dtype == dtype:
        return t
    return t.bool() if dtype == torch.bool else t.view(dtype)


class Communicator:
    """The collectives of one process group, each call counted by kind in
    :attr:`counts` ("all_reduce", "all_gather", "exchange" for a halo
    exchange, "p2p" for each of its sends and receives)."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.device = device
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._peer = [dist.get_global_rank(group, r) for r in range(self.world)]
        self.counts: Counter = Counter()

    def reset_counts(self):
        self.counts = Counter()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (``op="min"``, ``"max"``: the least, the largest) of ``t``
        over the ranks, a new tensor of ``t``'s shape."""
        out = t.reshape(-1).clone()
        self.counts["all_reduce"] += 1
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out.reshape(t.shape)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along the first axis in rank order
        (``jax.lax.all_gather(..., tiled=True)``); bool and uint32 tensors
        cross as uint8 and int32."""
        dtype = t.dtype
        t = _carried(t.contiguous())
        out = torch.empty((self.world * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        self.counts["all_gather"] += 1
        _all_gather_single()(out, t, group=self.group)
        return _restored(out, dtype)

    def barrier(self):
        """Return once every rank called it: one all-reduce of one number,
        read back on the host.  Under NCCL the all-reduce only queues the
        reduction on the card, so the read is what waits for every rank."""
        self.counts["barrier"] += 1
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.group)
        t.item()

    def exchange(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        """``[S, ...]`` -> ``[halo + S + halo, ...]``: the left neighbour's
        last ``halo`` rows, this rank's slab, the right neighbour's first
        ``halo`` rows.  Ranks 0 and world - 1 get zeros past the domain's
        edge.  One ``batch_isend_irecv`` with ranks r - 1 and r + 1 only; a
        world of one rank sends nothing."""
        S = x.shape[0]
        if halo > S:
            raise ValueError(f"halo width {halo} exceeds the slab of {S} rows")
        left = x.new_zeros((halo,) + tuple(x.shape[1:]))
        right = x.new_zeros((halo,) + tuple(x.shape[1:]))
        self.counts["exchange"] += 1
        if halo and self.world > 1:
            ops = []
            if self.rank > 0:
                peer = self._peer[self.rank - 1]
                ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), peer, self.group),
                        dist.P2POp(dist.irecv, left, peer, self.group)]
            if self.rank < self.world - 1:
                peer = self._peer[self.rank + 1]
                ops += [dist.P2POp(dist.isend, x[S - halo:].contiguous(), peer, self.group),
                        dist.P2POp(dist.irecv, right, peer, self.group)]
            self.counts["p2p"] += len(ops)
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.cat([left, x, right])


#: the axes of the port's meshes: the site axis (the replicated and halo
#: decompositions of one structure) and the replica axis (``parallel.batched``)
AXES = ("sites", "batch")


def _check_axes(axis_names: Tuple[str, ...]):
    if not 1 <= len(axis_names) <= 2 or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"a mesh of axes {axis_names}: the port's meshes have one axis or "
                         f"two distinct ones, of {AXES}")
    for name in axis_names:
        if name not in AXES:
            raise ValueError(f"unknown mesh axis {name!r}; expected one of {AXES}")


def _lines(shape: Tuple[int, ...], dim: int) -> List[List[int]]:
    """The mesh ranks of each line along ``dim`` of a row-major mesh of
    ``shape``: the ranks that share every other coordinate, in order."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    return [list(map(int, line)) for line in np.moveaxis(grid, dim, -1).reshape(-1, shape[dim])]


class Mesh:
    """One rank's view of a mesh of ``world`` ranks with one axis or two,
    ``axis_names`` (of ``"sites"`` and ``"batch"``) of sizes ``shape``: the
    process group, this rank, the world size, this rank's device and its
    :class:`Communicator` over the whole mesh.  Mesh rank r sits at
    ``numpy.unravel_index(r, shape)``, row-major, as the JAX package
    reshapes its device list (``devicekmc_tpu/parallel/mesh.py:43-46``).

    :meth:`axis` gives the 1-D view of one axis: a mesh over the sub-group
    of the ranks that share this rank's other coordinate (its rank there is
    this rank's coordinate along the axis).  A 2-D mesh makes
    the sub-groups of both axes when it is made (every rank makes every
    sub-group, in the same order: ``dist.new_group`` is collective over the
    world)."""

    def __init__(self, group, device: torch.device, axis_names: Tuple[str, ...] = ("sites",),
                 shape: Optional[Sequence[int]] = None):
        axis_names = tuple(axis_names)
        _check_axes(axis_names)
        self.axis_names = axis_names
        self.group = group
        self.device = device
        self.comm = Communicator(group, device)
        self.rank = self.comm.rank
        self.world = self.comm.world
        if shape is None:
            shape = [self.world] + [1] * (len(axis_names) - 1)
        self.shape = tuple(int(n) for n in shape)
        if len(self.shape) != len(axis_names) or int(np.prod(self.shape)) != self.world:
            raise ValueError(f"a mesh of shape {self.shape} over axes {axis_names} needs "
                             f"{int(np.prod(self.shape))} ranks; the process group has "
                             f"{self.world}")
        #: the global ranks of every line of this mesh's axis (a 1-D mesh:
        #: its own ranks; an axis view: each line of its parent's axis)
        self.lines = [list(self.comm._peer)]
        self._cpu_group = None
        self._views = {}
        if len(axis_names) == 1:
            self._views[axis_names[0]] = self
            return
        for dim, name in enumerate(axis_names):
            lines = [[self.comm._peer[r] for r in line] for line in _lines(self.shape, dim)]
            sub, _ = dist.new_subgroups_by_enumeration(lines)
            view = Mesh(sub, device, (name,))
            view.lines = lines
            self._views[name] = view

    def axis(self, name: str) -> "Mesh":
        """The 1-D mesh along ``name`` that holds this rank: itself on a 1-D
        mesh along ``name``.  Raises ValueError when the mesh has no such
        axis."""
        if name not in self._views:
            raise ValueError(f"this needs a mesh along {name!r}; this mesh's axes are "
                             f"{self.axis_names} (make_mesh(axis_names=({name!r},)))")
        return self._views[name]

    def cpu_group(self):
        """A gloo group over this mesh's ranks, for collectives that run on
        the host beside the mesh's own (checkpoints, whose background writes
        must not interleave with a superstep's collectives on the mesh's
        group).  Made at the first call, which is collective over the world:
        every rank calls it at once (on an axis view, the ranks of every line
        of the axis), and every line gets its group."""
        if self._cpu_group is None:
            self._cpu_group, _ = dist.new_subgroups_by_enumeration(self.lines, backend="gloo")
        return self._cpu_group


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis_names: Tuple[str, ...] = ("sites",), shape: Optional[Sequence[int]] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's mesh over the default process group, along
    ``axis_names`` (``("sites",)``: one structure's sites, the default;
    ``("batch",)``: the replicas of an ensemble; ``("batch", "sites")``:
    replicas over the first axis, each replica's sites over the second) of
    sizes ``shape`` (default ``[world] + [1] * (len(axis_names) - 1)``, as
    the JAX package's ``make_mesh``): NCCL for ``device="cuda"`` (the rank's
    card is ``cuda:LOCAL_RANK``), gloo for ``"cpu"``.  Without a process
    group, one is started from torchrun's environment
    (``multihost.initialize``), or, without that either, as a world of one
    process.  ``n_devices`` (default: the world size) must equal the world
    size, and so must the product of ``shape``; an unknown axis or an
    existing group of another backend than the device's raises ValueError.
    Nothing falls back to another device or backend."""
    from . import multihost

    dev_type = torch.device(device).type
    if dev_type not in BACKENDS:
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    backend = BACKENDS[dev_type]
    dev = resolve_device(f"cuda:{_local_rank()}" if dev_type == "cuda" else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and not multihost.initialize(device=dev_type,
                                                              timeout=timeout):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"make_mesh: the process group runs {have!r}, device {device!r} "
                         f"needs {backend!r}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: need {n_devices} devices, the process group has "
                         f"{world} ranks (one device a rank)")
    return Mesh(dist.group.WORLD, dev, axis_names, shape)
