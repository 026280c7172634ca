"""The mesh of the port's multi-card layers: one process a card, over
``torch.distributed``, the port of ``devicekmc_tpu/parallel/mesh.py``.

The JAX package's mesh is a 1-D array of devices along the ``"sites"`` axis
that one program drives.  Here each rank is a process that drives its own
card (NCCL) or its own CPU (gloo), and :class:`Mesh` holds what a rank needs
to know of the others: the process group, its rank, the world size, its
device and the mesh's one axis (``"sites"`` or ``"batch"``).
:class:`Communicator` carries the collectives of the halo and replicated
paths (the neighbour exchange, sums and gathers) and counts its calls by
kind.

A world of one rank needs no launcher: :func:`make_mesh` then starts a
one-process group itself.  A larger world is started by ``torchrun``
(``multihost.initialize``) or by the caller's ``init_process_group``.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter
from typing import Optional, Tuple

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


#: the 1-D meshes of the port: the site axis (the replicated and halo
#: decompositions of one structure) and the replica axis (``parallel.batched``)
AXES = ("sites", "batch")


class Mesh:
    """One rank's view of a 1-D mesh of ``world`` ranks along its one axis,
    ``axis_names`` (``("sites",)`` or ``("batch",)``): the process group,
    this rank, the world size, this rank's device and its
    :class:`Communicator`."""

    def __init__(self, group, device: torch.device, axis_names: Tuple[str, ...] = ("sites",)):
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise NotImplementedError(
                f"a mesh of axes {axis_names}: the port's meshes are 1-D, ('sites',) or "
                "('batch',); the 2-D ('batch', 'sites') mesh is not ported yet (ROADMAP §1 "
                "item 5)")
        if axis_names[0] not in AXES:
            raise ValueError(f"unknown mesh axis {axis_names[0]!r}; expected one of {AXES}")
        self.axis_names = axis_names
        self.group = group
        self.device = device
        self.comm = Communicator(group, device)
        self.rank = self.comm.rank
        self.world = self.comm.world

    def require_axis(self, axis: str, what: str):
        """Raise ValueError unless the mesh runs along ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"{what} needs a mesh along {axis!r}; this mesh's axes are "
                             f"{self.axis_names} (make_mesh(axis_names=({axis!r},)))")


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis_names: Tuple[str, ...] = ("sites",),
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's mesh over the default process group, along
    ``axis_names`` (``("sites",)``: one structure's sites, the default;
    ``("batch",)``: the replicas of an ensemble): NCCL for
    ``device="cuda"`` (the rank's card is ``cuda:LOCAL_RANK``), gloo for
    ``"cpu"``.  Without a process group, one is started from torchrun's
    environment (``multihost.initialize``), or, without that either, as a
    world of one process.  ``n_devices`` (default: the world size) must equal
    the world size; an existing group of another backend than the device's
    raises.  Nothing falls back to another device or backend."""
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
    return Mesh(dist.group.WORLD, dev, axis_names)
