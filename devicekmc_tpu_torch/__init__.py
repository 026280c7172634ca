"""devicekmc_tpu_torch — the PyTorch / CUDA port of ``devicekmc_tpu``, a
kinetic Monte Carlo simulator for VCM RRAM devices (filament formation and
dissolution in TiN-HfO2/Ti-TiN stacks), for one NVIDIA Hopper card.

Ported: charge rule, boundary-potential CG, compacted gridless Poisson, the
residence-time event loop, charge transport (blocked and dense), Joule
heating, the engine's run modes, and device ensembles
(``parallel.batched``: B replicas of one device through one superstep), with
the neighbour gather, the Poisson pair sweep, the banded matvec, the
on-the-fly WKB products, the window-integral block, the event loop and the
boundary CG iteration as hand-written CUDA kernels (``csrc/``).  The
headline configuration runs each superstep, batch and ensemble call as one
captured CUDA graph (``superstep.SuperstepGraph``).  Over several cards
(``parallel.make_mesh``, one process a card under ``torchrun``) one
structure runs as the replicated decomposition (``Simulation(cfg,
mesh=mesh)``) or the halo-exchange one (``decomposition="halo"``), and an
ensemble's replicas split along ``"batch"`` (with each replica's sites
along ``"sites"`` on a 2-D mesh).  Checkpoints are npz files, which the JAX
package reads too, or ``torch.distributed.checkpoint`` directories, written
in place or in the background.  ``postprocessing`` and ``io`` are the JAX
package's log parsers, plots and matrix dumps.

Quick start::

    from devicekmc_tpu_torch import parse_parameters, Simulation
    cfg = parse_parameters("parameters.txt")
    sim = Simulation(cfg)              # device="cuda"; device="cpu" for the CPU
    sim.run()
"""

from .config import KMCConfig, Layer, parse_parameters
from .engine import Simulation
from .state import (
    Geometry,
    PhysParams,
    SimState,
    build_geometry,
    build_params,
    build_simulation,
    from_jax_arrays,
    init_state,
)
from .structure import Element, make_test_structure, read_xyz, write_xyz

__all__ = [
    "KMCConfig",
    "Layer",
    "parse_parameters",
    "Simulation",
    "Geometry",
    "PhysParams",
    "SimState",
    "build_geometry",
    "build_params",
    "build_simulation",
    "from_jax_arrays",
    "init_state",
    "Element",
    "make_test_structure",
    "read_xyz",
    "write_xyz",
]
