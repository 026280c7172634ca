"""Multi-process start, the port of ``devicekmc_tpu/parallel/multihost.py``.

Under ``torchrun`` every process calls :func:`initialize` once before it
builds its simulation; each then drives one card, ``make_mesh()`` spans all
ranks, and only the coordinator (rank 0) writes output files::

    from devicekmc_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize()                  # no-op outside torchrun
    mesh = make_mesh()
    sim = Simulation(cfg, mesh=mesh, decomposition="halo")
    sim.run()

A failed start raises: nothing carries on as a single process.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def initialize(device: str = "cuda",
               timeout: datetime.timedelta = datetime.timedelta(minutes=10)) -> bool:
    """Start the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL
    for ``device="cuda"``, gloo for ``"cpu"``, each collective bounded by
    ``timeout``.  Returns True when a group runs after the call (started now
    or before), False without torchrun's environment (a single process, no
    group).  A failed start raises."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    from .mesh import BACKENDS

    if device not in BACKENDS:
        raise ValueError(f"initialize: unsupported device {device!r}")
    env = {k: os.environ[k] for k in _ENV}
    dist.init_process_group(
        BACKENDS[device], init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]), timeout=timeout)
    return True


def is_coordinator() -> bool:
    """True on rank 0, and in a process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
