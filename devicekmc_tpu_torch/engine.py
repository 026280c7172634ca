"""Simulation engine: bias sweep, superstep loop, logging, snapshots.

Mirrors the reference main loop (src/kmc_main.cpp:26-299) for the ported
module set (charge, boundary potential, gridless Poisson, KMC events, charge
transport blocked or dense, dissipated power, global and local heat): for
each bias point (V_switch[i], t_switch[i])
the cold systems are pre-solved (with ``solve_current`` the CB edge and, in
chunked mode, the transport network; the boundary network, deflated CG),
then supersteps run until the KMC clock passes t_switch[i] or the
compliance current trips.  Output goes to ``output.txt`` with the
reference's keys and to xyz snapshots in ``Results_<Vd>/``, as
``devicekmc_tpu.engine`` writes them.

Two superstep forms: ``fused=True`` runs ``superstep.superstep_impl`` whole;
``fused=False`` runs it phase by phase with a device synchronization between
phases and logs the reference's per-module times (``Z - calculation time -
<phase> [s]``, src/kmc_main.cpp:272-277), and with ``solver_chunk_iters > 0``
runs the in-superstep boundary and transport re-solves and the local cg heat
model in bounded segments.  A full-state checkpoint
(:meth:`Simulation.save_checkpoint`) resumes a run bit for bit, also in the
middle of a bias point: an npz file, which the JAX package reads and writes
too, or a ``torch.distributed.checkpoint`` directory, written in place or in
the background (the counterparts of the JAX package's orbax backends).

With a mesh (``parallel.make_mesh``) every rank runs the same bias loop, a
superstep a call, no batches and no graph, and only rank 0 writes
output.txt, the snapshots and npz checkpoints (every rank writes its part
of a directory checkpoint).  ``decomposition="replicate"``
(the default) keeps the whole state on every rank and splits the phases
that read pair arrays by site rows (``parallel.sharding``);
``decomposition="halo"`` gives each rank its x-slab of the sites
(``parallel.halo_superstep``; with ``solve_current`` the blocked transport,
power and heat of ``parallel.halo_transport``), the metrics summed over the
ranks.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from . import rng
from .config import KMCConfig
from .device import resolve_device
from .physics import current as current_mod
from .physics import events as events_mod
from .physics import heat as heat_mod
from .state import attach_tunnel_state, build_simulation, replace
from .structure import Element, write_xyz
from .superstep import (  # noqa: F401  (the JAX package's engine names)
    HEAT_SUBSTEPS_PER_DISPATCH, _phase_boundary, _phase_cb_edge, _phase_charge,
    _phase_events, _phase_heat, _phase_heat_finish, _phase_heat_steady,
    _phase_heat_window, _phase_poisson, _phase_power, _phase_power_chunk,
    SuperstepGraph, _phase_transport_cache, chunked_boundary_resolve, graph_ready,
    multi_superstep_impl, run_heat_phase_chunked, segments, superstep_impl)


#: metrics kept in ``step_log`` but not written to output.txt, whose keys are
#: those of the JAX package
_UNLOGGED = {"boundary_converged", "transport_partial_assembly"}

#: the checkpoint backends: one npz file in the JAX package's layout, a
#: ``torch.distributed.checkpoint`` directory, the same written in the
#: background
CHECKPOINT_BACKENDS = ("npz", "dcp", "dcp_async")
#: the JAX package's orbax backends, and their counterparts here
JAX_BACKENDS = {"orbax": "dcp", "orbax_async": "dcp_async"}

def make_superstep(geom, params, heat, graph: Optional[SuperstepGraph] = None):
    """The superstep as one call.  Returns ``superstep(state, Vd, cc=None) ->
    (state, step_time, metrics)``.  With ``graph`` (a
    ``superstep.SuperstepGraph`` of one replica, for the configurations of
    ``superstep.graph_ready``) each call replays the superstep's captured
    graph and reads its result once; otherwise it runs
    ``superstep.superstep_impl`` eagerly."""
    if graph is not None:
        graph.set_params(params)

        def superstep(state, Vd, cc=None):
            return graph.step(state, Vd, cc)

        return superstep

    def superstep(state, Vd, cc=None):
        return superstep_impl(geom, params, state, Vd, cc=cc, heat=heat)

    return superstep


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_modular_superstep(geom, params, heat, chunk_iters: int = 0):
    """``superstep_impl`` with the device synchronized after each phase and
    the reference's per-module timing keys (src/kmc_main.cpp:272-277):
    ``Z - calculation time - <phase> [s]`` for charge, potential from
    boundaries, potential from charges, kmc events, dissipated power and
    temperature.  Without chunks the result is the fused superstep's, bit
    for bit.

    ``chunk_iters > 0`` runs the in-superstep boundary and transport
    re-solves as restarted CG in segments of ``chunk_iters`` iterations,
    each warm-started from the last, and the local cg heat model in segments
    of HEAT_SUBSTEPS_PER_DISPATCH substeps (run_heat_phase_chunked), so that
    no single call runs long.  Every segment loop ends on the solver's own
    ``converged`` flag; the transport segments keep the unchanged-network
    skip and transport_warm_precond, and the last transport call's
    ``transport_converged`` is logged (a warning when 0).  Converged results
    equal the unchunked ones to the solver tolerance."""
    dev = geom.device

    def superstep(state, Vd, cc=None):
        times: Dict = {}

        def timed(key, fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(dev)
            times[f"Z - calculation time - {key} [s]"] = time.perf_counter() - t0
            return out

        _sync(dev)
        state, step_time, metrics = superstep_impl(
            geom, params, state, Vd, cc=cc, heat=heat, chunk_iters=chunk_iters,
            phase=timed)
        metrics.update(times)
        return state, step_time, metrics

    return superstep


# ----------------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------------

class Simulation:
    """End-to-end KMC simulation of the ported module set on one device
    (default the CUDA card; ``device="cpu"`` runs the plain versions).
    ``fused=False`` selects the modular superstep (make_modular_superstep,
    with ``cfg.solver_chunk_iters`` as its segment length); ``batch_steps >
    1`` then runs per step, as in the JAX package.

    Fused, the configurations of ``superstep.graph_ready`` (the headline
    module set, and with ``solve_current`` the blocked mixed transport on the
    fly with the band, with or without the bf16 inner operator, heating off,
    global or local) run every superstep, and every
    batch of ``batch_steps``, as one replay of a captured CUDA graph
    (``superstep.SuperstepGraph``, on the CPU its plain version) and one read
    of its result; the state then stays in the graph's buffers between
    replays, and ``state`` is a view of them.  The others run eagerly.

    ``mesh`` (``parallel.make_mesh``, along ``"sites"``) with
    ``decomposition="replicate"``, the default, runs the superstep over the
    replicated decomposition (``parallel.sharding``, the JAX package's
    ``engine.py:308``): the site axis padded to the world size, the whole
    state on every rank (``state`` is the whole state, the same bits on
    every rank), each rank's rows of the pair arrays, the phases that read
    them split by rows and made whole by collectives, the event loop,
    transport, power and heat the single device's on every rank, one
    superstep a call; no band and no persistent tunnel store.

    With ``decomposition="halo"`` it runs the superstep over the halo
    decomposition
    (``parallel.halo_superstep``, the JAX package's ``engine.py:316-321``):
    the site axis padded to ``world * events._BLOCK``, each rank holding its
    x-slab on the mesh's device (``state`` is this rank's slab;
    :meth:`global_field` gathers a whole field), the cold boundary solve and
    every superstep as distributed CG and events, one superstep a call;
    with ``solve_current`` (``transport="blocked"``; local heat with
    ``heat_solver="cg"``) the CB edge solved on the slabs, this rank's rows
    of the metal block stored a bias point, the transport solve and the heat
    every superstep over the ranks, and no cold transport pre-solve.

    Under either decomposition :meth:`save_checkpoint` and
    :meth:`load_checkpoint` are collectives that every rank calls: for npz
    rank 0 writes the whole padded state, and every rank reads it (its slab
    of it under halo); for a dcp directory every rank writes and reads its
    part (under halo its slab of each site field, nothing gathered); a
    checkpoint resumes on a run of the same world size and decomposition.
    The mesh must be 1-D along ``"sites"``: a 2-D mesh raises."""

    #: the checkpoint's state fields and grown caps, under the JAX package's
    #: names (devicekmc_tpu/engine.py), so that both read one npz
    _CKPT_STATE_FIELDS = (
        "element", "charge", "potential_boundary",
        "potential_charge", "CB_edge", "power", "temperature",
        "T_bg", "key", "kmc_time", "I_macro", "P_tot",
        "virtual_potentials", "step_count", "cvac_prev", "Vd_prev",
        "boundary_r", "boundary_b",
        "trans_elem_prev", "trans_charge_prev", "transport_Vd_prev",
    )
    _CKPT_CAP_FIELDS = (
        "active_rows_cap", "tunnel_vac_cap", "poisson_compact_cap",
        "tunnel_int_steps",
    )

    def __init__(
        self,
        cfg: KMCConfig,
        elements: Optional[np.ndarray] = None,
        coords: Optional[np.ndarray] = None,
        neigh_idx=None,
        device=None,
        fused: bool = True,
        mesh=None,
        decomposition: str = "replicate",
    ):
        self.cfg = cfg
        self.fused = fused
        self.mesh = mesh
        self.decomposition = decomposition if mesh is not None else "none"
        if mesh is not None:
            if decomposition not in ("halo", "replicate"):
                raise ValueError(f"unknown decomposition {decomposition!r}; expected "
                                 "'halo' or 'replicate'")
            if len(mesh.axis_names) != 1:
                raise ValueError(f"Simulation runs on a 1-D mesh along 'sites' (the JAX "
                                 f"package's engine.py:310); this mesh's axes are "
                                 f"{mesh.axis_names}")
            mesh.axis("sites")
            if device is not None and torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} differs from the mesh's {mesh.device}")
            device = mesh.device
        #: the rank that writes output.txt and the snapshots
        self._writer = mesh is None or mesh.rank == 0
        if fused:
            self._make = lambda g, p, h: make_superstep(g, p, h, self._graph_for(p))
        else:
            self._make = lambda g, p, h: make_modular_superstep(
                g, p, h, chunk_iters=cfg.solver_chunk_iters)
        self._step_params = self._step = None
        self._graph: Optional[SuperstepGraph] = None
        self.device = resolve_device("cuda" if device is None else device)
        halo = self.decomposition == "halo"
        pad_to = 1 if mesh is None else mesh.world * (events_mod._BLOCK if halo else 1)
        self.geom, self.params, self.state = build_simulation(
            cfg, elements=elements, coords=coords, neigh_idx=neigh_idx,
            device=self.device, pad_to=pad_to,
        )
        if cfg.solve_heating_local and (not halo or cfg.heat_solver == "cg"):
            # the reference's contact-span rule; crossbars with interior metal
            # build their model with symmetric spans (heat.build_heat_model)
            # and assign it to ``heat`` (on one device).  Under the halo
            # decomposition the whole structure's model, cut to the slab by
            # _init_halo; its dense model raises there
            self.heat = heat_mod.build_heat_model(
                self.geom, self.params, cfg, self._elements_np(),
                self.geom.neigh_idx.cpu().numpy(), method=cfg.heat_solver)
        else:
            self.heat = heat_mod.empty_heat_model(self.params, self.device)
        if cfg.poisson_compact_cap == -1:
            self.params = replace(self.params, poisson_compact_cap=self._auto_poisson_cap())
        if cfg.active_rows_cap == -1:
            self.params = replace(self.params, active_rows_cap=self._auto_active_cap())
        # per-bias-point cache of the blocked transport operator (the metal
        # block, constant within a bias point) and the static banded operator
        self._cc = None
        self._band = None
        self._tt_stale = False
        if halo:
            self._init_halo()
        elif cfg.solve_current:
            self._init_transport()
        if self.decomposition == "replicate":
            self._init_replicate()
        self._buffer: List[str] = []
        self.output_path = os.path.join(cfg.output_dir, "output.txt")
        #: one dict per superstep run: the logged metrics, keyed as in output.txt
        self.step_log: List[Dict] = []
        #: one dict per bias-start cold solve: phase ("cb_edge", "boundary",
        #: "transport"), CG iterations, seconds
        self.presolve_log: List[Dict] = []
        #: driver position for checkpoint and resume: (bias index, step
        #: within that bias point)
        self._pos = (0, 0)
        #: the JAX state's step_count, which nothing advances: carried
        #: through a checkpoint as read
        self._step_count = 0
        #: the in-flight dcp_async write (a Future; wait_for_checkpoint)
        self._pending_save = None

    def _init_transport(self):
        """Resolve the transport options that depend on the structure: the
        vacancy bucket, stored or on-the-fly metal block, persistent tunnel
        blocks; build the static band.  Under a mesh the tunnel blocks stay
        off and no band is built, as in the JAX package
        (``devicekmc_tpu/engine.py:407-417``, ``:580-586``)."""
        cfg = self.cfg
        n_mp = int(self.geom.atom_metalp_idx.shape[0])
        if cfg.tunnel_vac_cap == -1:
            # n_vac <= the V + Od species count, the Poisson bucket's bound
            self.params = replace(self.params, tunnel_vac_cap=self._auto_poisson_cap())
        if self.params.transport != "blocked":
            # the dense path stores nothing per bias point and has no band
            return
        f32_entries = self.params.mixed or self.params.dtype == torch.float32
        self.params = replace(self.params, transport_cc=current_mod.resolve_transport_cc(
            self.params.transport_cc, n_mp, f32_entries))
        if self.mesh is None:
            self.params = replace(
                self.params,
                transport_incremental=current_mod.resolve_transport_incremental(
                    cfg.transport_incremental, self.params, n_mp))
        self.state = attach_tunnel_state(self.state, self.geom, self.params)
        if cfg.transport_banded and self.mesh is None:
            # built once: metal sites and the atom graph never change
            self._band = current_mod.build_banded_nb(self.geom, self.params, self.state)
            if self._band is None:
                warnings.warn(
                    "transport_banded: the banded operator exceeds its size limit "
                    "for this structure and was not built; the f32 inner matvec "
                    "uses the ELL neighbour product", RuntimeWarning, stacklevel=2)

    def _init_halo(self):
        """Split the padded structure into this rank's slab and build its
        superstep (which raises for a configuration the halo path cannot
        run).  With ``solve_current``: the vacancy bucket resolved and the
        transport's static tables made from the whole structure first; the
        persistent tunnel rows stay off and no band is built (the JAX
        package's halo path has neither).  Rank 0 keeps the whole file order
        and coordinates for the snapshots."""
        from .parallel import halo_superstep as hs
        from .parallel.halo_transport import build_transport_static

        hs.check_halo_config(self.params, self.heat.method)
        self._halo_width = hs.required_halo(self.geom)
        ts = sizes = None
        if self.cfg.solve_current:
            if self.cfg.tunnel_vac_cap == -1:
                self.params = replace(self.params, tunnel_vac_cap=self._auto_poisson_cap())
            ts, sizes = build_transport_static(self.geom, self.params, self._elements_np(),
                                               self.mesh)
        if self._writer:
            self._site_io = (self.geom.io_idx.long(), self.geom.coords)
        n_sites = self.geom.N
        self.geom, self.state = hs.shard_halo_simulation(self.geom, self.state, self.mesh)
        self.heat = hs.shard_heat_model(self.heat, n_sites, self.mesh)
        #: the halo transport's static tables and sizes (build_transport_static)
        self.transport_static = (ts, sizes)
        self._halo_cc = hs.make_halo_cc_cache(self.geom, self.mesh, ts, sizes)
        self._make = lambda g, p, h: hs.make_halo_superstep(
            g, p, h, self.mesh, self._halo_width, ts, sizes)
        self._current_step()

    def _init_replicate(self):
        """Place the whole structure on the mesh's device with this rank's
        rows of the pair arrays, and build its superstep over the replicated
        decomposition."""
        from .parallel import sharding

        self.geom, self.state = sharding.shard_simulation(self.geom, self.state, self.mesh)
        self._make = lambda g, p, h: sharding.make_sharded_superstep(g, p, h, self.mesh)

    def _current_step(self):
        if self._step_params is not self.params:
            # built once, and again when the params change (a cap grew, a
            # checkpoint restored its caps)
            self._step_params = self.params
            self._step = self._make(self.geom, self.params, self.heat)
        return self._step

    def _superstep(self, state, Vd):
        return self._current_step()(state, Vd, self._cc)

    def global_field(self, name: str) -> torch.Tensor:
        """The state's per-site field ``name`` for the whole structure: under
        the halo decomposition gathered from every rank's slab (a collective
        that every rank calls), else the field itself."""
        x = getattr(self.state, name)
        return self.mesh.comm.all_gather(x) if self.decomposition == "halo" else x

    def _graph_for(self, params) -> Optional[SuperstepGraph]:
        """The captured superstep of one replica when the fused driver runs
        ``params`` as a graph (made once, told of changed params), else
        None."""
        if (not self.fused or self.mesh is not None
                or graph_ready(params, band=self._band is not None) is not None):
            return None
        if self._graph is None:
            self._graph = SuperstepGraph(self.geom, params, 1, heat=self.heat)
        self._graph.set_params(params)
        self._graph.set_heat(self.heat)
        return self._graph

    def _msuperstep(self, state, Vd, Icc_A, t_end, limit):
        graph = self._graph_for(self.params)
        if graph is not None:
            return graph.multi(state, Vd, Icc_A, t_end, self.cfg.batch_steps, limit=limit,
                               cc=self._cc)
        return multi_superstep_impl(self.geom, self.params, state, Vd, Icc_A, t_end,
                                    self.cfg.batch_steps, cc=self._cc, heat=self.heat,
                                    limit=limit)

    @staticmethod
    def _batch_peaks(metrics: Dict) -> Dict:
        """The largest value of each metric over a batch's steps that ran:
        what the caps of the batch are checked against."""
        return {k: float(v[metrics["active"]].max()) for k, v in metrics.items()
                if k != "active"}

    def _sync(self):
        _sync(self.device)

    # -- compaction buckets ---------------------------------------------
    def _elements_np(self) -> np.ndarray:
        return self.state.element.cpu().numpy()

    def _auto_poisson_cap(self) -> int:
        """Power-of-two bucket covering every chargeable site (the V / Od
        count bounds the charged count, so compaction stays exact)."""
        e = self._elements_np()
        n_species = int(((e == int(Element.VACANCY))
                         | (e == int(Element.OXYGEN_DEFECT))).sum())
        cap = 256
        while cap < min(self.geom.N, int(1.3 * n_species) + 8):
            cap *= 2
        return min(cap, self.geom.N)

    def _auto_active_cap(self) -> int:
        """Power-of-two bucket over candidate event-source rows (elements
        in {d, Od, V}); 0 (the full table) when they are a large fraction
        of the sites."""
        e = self._elements_np()
        n_src = int(((e == int(Element.DEFECT))
                     | (e == int(Element.OXYGEN_DEFECT))
                     | (e == int(Element.VACANCY))).sum())
        if n_src > self.geom.N // 8:
            return 0
        cap = 1024
        while cap < min(self.geom.N, int(1.25 * n_src) + 16):
            cap *= 2
        return min(cap, self.geom.N)

    def _maybe_grow_active_cap(self, metrics: Dict) -> bool:
        """True if the step ran on an overflowing row bucket (redo it)."""
        n_active = metrics.get("n_active_rows")
        cap = self.params.active_rows_cap
        if n_active is None or cap <= 0:
            return False
        n_active = int(n_active)
        overflow = n_active >= cap
        if self.cfg.active_rows_cap != -1:
            if overflow:
                raise RuntimeError(
                    f"active-row bucket overflow: n_active={n_active} >= "
                    f"fixed active_rows_cap={cap}; raise the cap (or set -1 "
                    "for automatic growth)"
                )
            return False
        if overflow or n_active > 0.75 * cap:
            new_cap = min(max(cap * 2, 1024), self.geom.N)
            if new_cap != cap:
                self.params = replace(self.params, active_rows_cap=new_cap)
        return overflow

    def _maybe_grow_poisson_cap(self, metrics: Dict) -> bool:
        """Charged-site bucket: grown when the V/Od species count nears it;
        True (redo) when the charged count exceeded it."""
        cap = self.params.poisson_compact_cap
        if cap <= 0:
            return False
        n_charged = metrics.get("n_charged_sites")
        n_charged = None if n_charged is None else int(n_charged)
        overflow = n_charged is not None and n_charged > cap
        if self.cfg.poisson_compact_cap != -1:
            if overflow:
                raise RuntimeError(
                    f"Poisson charged-site bucket overflow: "
                    f"n_charged={n_charged} > fixed poisson_compact_cap="
                    f"{cap}; raise the cap (or set -1)"
                )
            return False
        keys = ("Charged vacancies", "Uncharged vacancies",
                "Charged oxygen ions", "Uncharged oxygen ions")
        n_species = (sum(int(metrics[k]) for k in keys)
                     if all(k in metrics for k in keys) else None)
        need = max(n_charged or 0, n_species or 0)
        if overflow or (n_species is not None and n_species > 0.75 * cap):
            new_cap = cap
            while new_cap < min(self.geom.N, max(int(1.3 * need) + 8, 256)):
                new_cap *= 2
            new_cap = min(new_cap, self.geom.N)
            if new_cap != cap:
                self.params = replace(self.params, poisson_compact_cap=new_cap)
        return overflow

    def _maybe_grow_tunnel_cap(self, metrics: Dict) -> bool:
        """Vacancy bucket of the tunnel blocks: grown when the vacancy count
        nears it; True (redo) when the count reached it."""
        n_vac = metrics.get("n_vac_atoms")
        cap = self.params.tunnel_vac_cap
        if n_vac is None or cap <= 0:
            return False
        n_vac = int(n_vac)
        overflow = n_vac >= cap
        if self.cfg.tunnel_vac_cap != -1:
            if overflow:
                raise RuntimeError(
                    f"tunnel vacancy bucket overflow: n_vac={n_vac} >= fixed "
                    f"tunnel_vac_cap={cap}; raise the cap (or set -1)"
                )
            return False
        if overflow or n_vac > 0.75 * cap:
            new_cap = min(max(cap * 2, 256), self.geom.N_atom)
            if new_cap != cap:
                self.params = replace(self.params, tunnel_vac_cap=new_cap)
                self._tt_stale = True
        return overflow

    def _maybe_grow_tunnel_int_steps(self, metrics: Dict) -> bool:
        """Energy-window integration trip count.  The solver reports the
        count the widest contact->trap pair needed (ceil(max |dE_CB| /
        0.01 V)); above the configured count the integral was truncated:
        grow to the next power of two and redo.  The stored tunnel rows were
        summed with the old count, so the persistent store is dropped."""
        needed = metrics.get("tunnel_int_steps_needed")
        cur = self.params.tunnel_int_steps
        if needed is None or int(needed) <= cur:
            return False
        new = max(cur, 1)
        while new < int(needed):
            new *= 2
        self.params = replace(self.params, tunnel_int_steps=new)
        self._tt_stale = True
        return True

    def _check_caps(self, metrics: Dict) -> bool:
        redo = self._maybe_grow_active_cap(metrics)
        redo = self._maybe_grow_tunnel_cap(metrics) or redo
        redo = self._maybe_grow_poisson_cap(metrics) or redo
        redo = self._maybe_grow_tunnel_int_steps(metrics) or redo
        return redo

    def _redo_exhausted_msg(self, metrics: Dict) -> str:
        counts = {k: int(metrics[k])
                  for k in ("n_active_rows", "n_vac_atoms", "n_charged_sites",
                            "tunnel_int_steps_needed") if k in metrics}
        caps = {k: getattr(self.params, k)
                for k in ("active_rows_cap", "tunnel_vac_cap",
                          "poisson_compact_cap", "tunnel_int_steps")}
        return ("compaction bucket still overflowing after 4 grow-and-redo "
                f"attempts; counts={counts}, caps={caps}")

    def _step_with_redo(self, Vd: float):
        """One superstep on ``self.state``, redone with larger caps while a
        compaction bucket overflowed.  Returns the state before the step,
        the step time and the metrics."""
        return self._with_redo(lambda st: self._superstep(st, Vd))

    def _with_redo(self, step, counts=lambda metrics: metrics):
        """``step(state)`` -> (state, step time(s), metrics) on ``self.state``,
        redone from the state before it with larger caps while a compaction
        bucket overflowed; ``counts`` maps the metrics to the counts the caps
        are checked against (a batch's peaks).  Returns the state before the
        step, the step time(s) and the metrics."""
        prev_state = self.state
        self.state, step_time, metrics = step(prev_state)
        for attempt in range(5):
            redo = self._check_caps(counts(metrics))
            if self._tt_stale:
                # the tunnel bucket or the integration count grew: a fresh,
                # invalid store, so that the next assembly (the redo's too)
                # rebuilds every row
                prev_state = attach_tunnel_state(prev_state, self.geom, self.params)
                self.state = attach_tunnel_state(self.state, self.geom, self.params)
                self._tt_stale = False
            if not redo:
                break
            if attempt == 4:
                raise RuntimeError(self._redo_exhausted_msg(counts(metrics)))
            self.state, step_time, metrics = step(prev_state)
        return prev_state, step_time, metrics

    # -- bias-start cold solves -------------------------------------------
    def _cb_edge(self, params, state, Vd: float):
        """The CB-edge solve: over the ranks under a mesh (the slabs, or
        the rows of ``parallel.sharding.solve_cb_edge_sharded``)."""
        if self.decomposition == "halo":
            return self._current_step().cb_edge(state, Vd, params)
        if self.decomposition == "replicate":
            from .parallel.sharding import solve_cb_edge_sharded

            return solve_cb_edge_sharded(self.geom, params, state, Vd, self.mesh,
                                         rows=self._current_step().rows)
        return _phase_cb_edge(self.geom, params, state, Vd)

    # Restarted CG in segments of ``chunk`` iterations (superstep.segments).
    def _chunked_cb_edge(self, Vd: float, chunk: int, base_params=None) -> int:
        pchunk = replace(base_params or self.params, solver_maxiter=chunk)
        self.state, _, total = segments(
            lambda st: self._cb_edge(pchunk, st, Vd), self.state,
            "cg_iters_cb_edge", "cb_edge_converged", "CB-edge solve")
        return total

    def _chunked_boundary(self, Vd: float, chunk: int, base_params=None) -> int:
        """Charge rule, then the boundary network; returns the total
        iterations.  Under a mesh the charge rule and the boundary network
        are the decomposition's, the CG distributed over the ranks (deflated
        as ``base_params`` asks), in segments of ``chunk`` iterations, each
        warm-started from the last."""
        if self.decomposition == "halo":
            step = self._current_step()
            p = base_params or self.params
            slabs = p.coarse_slabs if p.boundary_precond == "deflated" else 0
            self.state, _ = step.charge(self.state)
            self.state, _, total = segments(
                lambda st: step.boundary(st, Vd, chunk, slabs), self.state,
                "cg_iters_boundary", "boundary_converged", "boundary solve")
            return total
        charge, boundary = _phase_charge, _phase_boundary
        if self.decomposition == "replicate":
            step = self._current_step()
            charge, boundary = (lambda g, p, st: step.charge(st)), step.boundary
        self.state, _ = charge(self.geom, self.params, self.state)
        self.state, m = chunked_boundary_resolve(self.geom, base_params or self.params,
                                                 self.state, Vd, chunk, boundary=boundary)
        return int(m["cg_iters_boundary"])

    def _chunked_transport(self, Vd: float, chunk: int) -> int:
        """Pre-solve the transport network cold (``transport_precond``).
        Commits ONLY the ``virtual_potentials`` warm start: I_macro (and, with
        heating on, the power the solve extracts) stays untouched, so the
        first superstep's IR drop and trajectory are those of an unchunked
        run, and its own transport solve starts converged."""

        def step(st):
            new, m = _phase_power_chunk(self.geom, self.params, st, Vd, cc=self._cc,
                                        cg_maxiter=chunk)
            return replace(st, virtual_potentials=new.virtual_potentials), m

        self.state, _, total = segments(step, self.state, "cg_iters_power",
                                        "transport_converged", "transport solve")
        return total

    def _presolve(self, phase: str, Vd: float, fn) -> float:
        t0 = time.perf_counter()
        iters = fn()
        self._sync()
        dt = time.perf_counter() - t0
        self.presolve_log.append({"phase": phase, "Vd": Vd, "cg_iters": iters, "s": dt})
        return dt

    # -- logging ---------------------------------------------------------
    def _log(self, text: str):
        self._buffer.append(text)

    def _flush(self):
        if not self._writer:
            self._buffer = []
        if self._buffer:
            with open(self.output_path, "a") as f:
                f.write("".join(self._buffer))
            self._buffer = []

    def write_snapshot(self, step_count: int, folder: str, elem_state=None,
                       field_state=None):
        """Write ``snapshot_<step>.xyz`` (element, x, y, z, phi_total, power;
        src/Device.cpp:236-252) in FILE order.  The reference writes it after
        the field solve and before the events (src/kmc_main.cpp:198-205):
        ``elem_state`` gives elements and power, ``field_state`` the
        potentials.  Under a mesh every rank calls it (under halo the fields
        are gathered from the slabs) and rank 0 writes."""
        es = self.state if elem_state is None else elem_state
        fs = self.state if field_state is None else field_state
        phi = fs.potential_boundary + fs.potential_charge
        elem, power = es.element, es.power
        io, coords = self.geom.io_idx.long(), self.geom.coords
        if self.decomposition == "halo":
            comm = self.mesh.comm
            phi, elem, power = (comm.all_gather(x) for x in (phi, elem, power))
            if self._writer:
                io, coords = self._site_io
        if not self._writer:
            return
        io = io[:self.geom.N_real]
        os.makedirs(folder, exist_ok=True)
        write_xyz(
            os.path.join(folder, f"snapshot_{step_count}.xyz"),
            elem[io].cpu().numpy(),
            coords[io].cpu().numpy(),
            extra_cols=[phi[io].cpu().numpy(), power[io].cpu().numpy()],
        )

    def _log_step_start(self, step_count: int, V_vcm: float):
        self._log("--------------\n")
        self._log(f"KMC step count: {step_count}\n")
        self._log(f"V_vcm: {V_vcm:g}\n")

    def _log_result(self, step_count: int, kmc_time: float, step_time: float,
                    result: Dict, dt: float) -> Dict:
        """Warnings, the clock and the metrics of one superstep (host
        numbers); ``dt`` its wall time.  Kept in ``step_log``; returns the
        result with the timing key."""
        for key in ("cg_iters_boundary", "cg_iters_power"):
            if result.get(key, 0) >= self.params.solver_maxiter:
                self._log(f"WARNING: {key} hit the iteration cap "
                          f"({self.params.solver_maxiter}) — solver may "
                          "not have converged.\n")
        if not result.get("transport_converged", 1.0):
            self._log("WARNING: the transport solve left above its "
                      "tolerance (transport_converged = 0).\n")
        result["Z - calculation time - KMC superstep [s]"] = dt
        self.step_log.append(dict(result, step=step_count, step_time=step_time))
        self._log(f"KMC time is: {kmc_time:g}\n")
        for k in sorted(set(result) - _UNLOGGED):
            self._log(f"{k}: {result[k]:.10g}\n")
        return result

    # -- checkpointing (full state, beyond the reference's xyz restart) ----
    def _site_slab(self, f: str) -> bool:
        """True when the state field ``f`` is this rank's slab of a site
        field (the halo decomposition)."""
        from .parallel.halo_superstep import STATE_SITE_FIELDS

        return self.decomposition == "halo" and f in STATE_SITE_FIELDS

    def _checkpoint_payload(self, gather: bool = True) -> Dict:
        """The npz payload, laid out as the JAX package writes it: per-site
        fields as arrays (the whole padded structure's: under halo gathered
        from the slabs, a collective; with ``gather=False`` this rank's
        slab), the host scalars as 0-d f64 arrays, the key as uint32[2], the
        caps as ``cap_<name>``, the driver position."""
        st = self.state
        p = {}
        for f in self._CKPT_STATE_FIELDS:
            if f == "step_count":
                p[f] = np.asarray(self._step_count, dtype=np.int32)
            elif f == "key":
                p[f] = np.asarray(st.key, dtype=np.uint32)
            else:
                v = getattr(st, f)
                if gather and self._site_slab(f):
                    v = self.mesh.comm.all_gather(v)
                p[f] = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.float64)
        for f in self._CKPT_CAP_FIELDS:
            p[f"cap_{f}"] = np.asarray(getattr(self.params, f))
        p["pos_bias_index"] = np.asarray(self._pos[0])
        p["pos_bias_step"] = np.asarray(self._pos[1])
        return p

    @staticmethod
    def _shape_error(f: str, got, want) -> ValueError:
        # another structure, or the same padded for another mesh
        return ValueError(
            f"checkpoint field {f!r} has shape {tuple(got)}, this simulation's is "
            f"{tuple(want)}: not a checkpoint of this structure padded as this run pads it "
            "(a checkpoint resumes on a run of the same world size and decomposition)")

    def _restore_payload(self, data: Dict, whole: bool = True):
        """Restore a payload of :meth:`_checkpoint_payload`'s names (the
        fields it holds).  ``whole``: under halo the site fields are the
        whole structure's (npz; this rank cuts its slab), else this rank's
        slab already (dcp)."""
        kw, caps = {}, {}
        for f, arr in data.items():
            if f.startswith("cap_"):
                caps[f[4:]] = int(arr)
            elif f == "pos_bias_index":
                self._pos = (int(arr), self._pos[1])
            elif f == "pos_bias_step":
                self._pos = (self._pos[0], int(arr))
            elif f == "step_count":
                self._step_count = int(arr)
            elif f == "key":
                kw[f] = rng.key_from_array(arr)
            else:
                cur = getattr(self.state, f)
                if not torch.is_tensor(cur):
                    kw[f] = float(arr)
                    continue
                a = np.asarray(arr)
                cut = whole and self._site_slab(f)
                want = tuple(cur.shape)
                if cut:
                    want = (self.geom.N,) + want[1:]
                if a.shape != want:
                    raise self._shape_error(f, a.shape, want)
                if cut:
                    S = self.geom.N // self.mesh.world
                    a = a[self.mesh.rank * S:(self.mesh.rank + 1) * S]
                kw[f] = torch.as_tensor(a, device=self.device).to(cur.dtype)
        if "boundary_r" not in data and "Vd_prev" in kw:
            # a payload without the residual anchor: force a full boundary
            # solve (a stale zero residual must never certify a skip)
            kw["Vd_prev"] = float("nan")
        self.state = replace(self.state, **kw)
        if caps:
            self.params = replace(self.params, **caps)
        # the persistent tunnel rows are not checkpointed: a fresh, invalid
        # store sized for the restored caps makes the next solve rebuild
        # every row (bit-equal to the incremental rows)
        self.state = attach_tunnel_state(self.state, self.geom, self.params)

    @staticmethod
    def _resolve_backend(path: str, backend: Optional[str]) -> str:
        """``backend``, by default "npz" for a ``*.npz`` path and "dcp" for
        any other (the JAX package's default is orbax there); the JAX
        package's orbax backends raise, naming their counterparts."""
        if backend is None:
            backend = "npz" if path.endswith(".npz") else "dcp"
        if backend in JAX_BACKENDS:
            raise ValueError(
                f"checkpoint backend {backend!r} is the JAX package's orbax format, which this "
                f"package neither writes nor reads; its counterpart here is "
                f"{JAX_BACKENDS[backend]!r} (a torch.distributed.checkpoint directory), and "
                "both packages read npz (a path ending in .npz, or backend='npz')")
        if backend not in CHECKPOINT_BACKENDS:
            raise ValueError(f"unknown checkpoint backend {backend!r}; expected one of "
                             f"{CHECKPOINT_BACKENDS}")
        return backend

    def _dcp_state_dict(self) -> Dict:
        """The payload as a ``torch.distributed.checkpoint`` state dict under
        the npz's names: host tensors, copies (a background write runs while
        the state moves on; in graph mode ``state`` is a view of the graph's
        buffers).  Under halo each site field is a ``DTensor`` of this
        rank's slab, sharded on dim 0 over the checkpoint group, so each rank
        writes and reads only its slab; under the replicated decomposition
        every rank holds the same tensors and DCP writes one copy."""
        sd = {f: torch.from_numpy(np.array(a)) for f, a in
              self._checkpoint_payload(gather=False).items()}
        if self.decomposition == "halo":
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import DTensor, Shard

            slabs = DeviceMesh.from_group(self.mesh.cpu_group(), "cpu")
            for f, t in sd.items():
                if self._site_slab(f):
                    shape = (self.geom.N,) + tuple(t.shape[1:])
                    sd[f] = DTensor.from_local(t, slabs, [Shard(0)], run_check=False,
                                               shape=torch.Size(shape),
                                               stride=torch.empty(shape, device="meta").stride())
        return sd

    def _dcp(self, op, sd: Dict, path: str):
        """``op`` (``dcp.save``, ``dcp.async_save`` or ``dcp.load``) of ``sd``
        at the directory ``path`` (a save overwrites it, as the JAX package's
        orbax saves force): under a mesh over the mesh's gloo checkpoint
        group (``Mesh.cpu_group``: a CPU backend, apart from the superstep's
        collectives), else in one process."""
        import torch.distributed.checkpoint as dcp

        kw = (dict(checkpoint_id=path) if op is dcp.load
              else dict(storage_writer=dcp.FileSystemWriter(path, overwrite=True)))
        if self.mesh is not None:
            return op(sd, process_group=self.mesh.cpu_group(), **kw)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
            return op(sd, no_dist=True, **kw)

    def save_checkpoint(self, path: str, backend: Optional[str] = None):
        """Full-state checkpoint: the state fields, the grown caps and the
        driver position (bias index, step), enough for a bit-exact resume
        also in the middle of a bias point.  ``backend`` (JAX
        ``engine.py:956-986``): "npz" (one file in the JAX package's layout,
        the default for a ``*.npz`` path), "dcp" (a
        ``torch.distributed.checkpoint`` directory, the default for any other
        path: the counterpart of the JAX package's orbax) or "dcp_async"
        (the payload copied to the host before this returns, the directory
        written in the background while the run goes on: the counterpart of
        orbax_async; :meth:`wait_for_checkpoint` blocks on the write).  A
        save first waits for an earlier background write.

        Under a mesh a collective that every rank calls.  npz: rank 0 writes
        the whole padded state (under halo gathered from the slabs), and no
        rank returns before the file is written.  dcp: every rank writes in
        parallel, under halo only its slab of each site field (no gather),
        and the directory is whole when the save (for dcp_async: the wait)
        returns on any rank."""
        backend = self._resolve_backend(path, backend)
        self.wait_for_checkpoint()
        if backend == "npz":
            payload = self._checkpoint_payload()
            if self._writer:
                np.savez(path, **payload)
            if self.mesh is not None:
                self.mesh.comm.barrier()
            return
        import torch.distributed.checkpoint as dcp

        op = dcp.save if backend == "dcp" else dcp.async_save
        pending = self._dcp(op, self._dcp_state_dict(), path)
        if backend == "dcp_async":
            self._pending_save = pending

    def load_checkpoint(self, path: str, backend: Optional[str] = None):
        """Restore a checkpoint: an npz of this package or of the JAX
        package, or a dcp directory of this package (``backend`` "dcp" or
        "dcp_async", which read alike; the defaults as in
        :meth:`save_checkpoint`).  Waits first for a background write, which
        may be the checkpoint being loaded (JAX ``engine.py:998-1013``).
        Under a mesh every rank reads (under halo it keeps, or from a dcp
        directory reads, only its slab of each site field); the checkpoint
        holds the structure padded as this run pads it (the same world size
        and decomposition)."""
        backend = self._resolve_backend(path, backend)
        self.wait_for_checkpoint()
        if backend == "npz":
            with np.load(path) as data:
                self._restore_payload({f: data[f] for f in data.files})
            return
        import torch.distributed.checkpoint as dcp
        from torch.distributed.tensor import DTensor

        # dcp.load fills the state dict in place: this run's own payload,
        # the fields the directory holds, each of the directory's shape
        saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        sd = {f: t for f, t in self._dcp_state_dict().items() if f in saved}
        for f, t in sd.items():
            if tuple(saved[f].size) != tuple(t.shape):
                raise self._shape_error(f, saved[f].size, t.shape)
        self._dcp(dcp.load, sd, path)
        self._restore_payload({f: (t.to_local() if isinstance(t, DTensor) else t).numpy()
                               for f, t in sd.items()}, whole=False)

    def wait_for_checkpoint(self):
        """Block until an in-flight dcp_async save has written its directory
        (JAX ``engine.py:992-996``); no-op when none is pending.  A write
        that failed raises here."""
        pending, self._pending_save = self._pending_save, None
        if pending is not None:
            pending.result()

    # -- main loop -------------------------------------------------------
    def run(self, max_steps_per_bias: Optional[int] = None) -> None:
        """Every bias point from the driver position on (a loaded checkpoint
        resumes where it was taken)."""
        cfg = self.cfg
        resume_bias, resume_step = self._pos
        if (self._writer and resume_bias == 0 and resume_step == 0
                and os.path.exists(self.output_path)):
            os.remove(self.output_path)
        for vt in range(resume_bias, len(cfg.V_switch)):
            self._pos = (vt, resume_step if vt == resume_bias else 0)
            summary = self.run_bias_point(
                float(cfg.V_switch[vt]), float(cfg.t_switch[vt]),
                max_steps=max_steps_per_bias, resume_step=self._pos[1],
            )
            if not summary.get("completed", True):
                # stopped by max_steps: the position stays inside the bias
                # point, so that a checkpoint taken now resumes here
                break
            self._pos = (vt + 1, 0)
        self._flush()
        self.wait_for_checkpoint()

    def run_bias_point(self, Vd: float, t_end: float,
                       max_steps: Optional[int] = None, resume_step: int = 0) -> Dict:
        """One bias point.  ``resume_step > 0`` resumes it from a checkpoint
        taken at that step: the cold solves are skipped (the saved CB edge is
        the bias-start solution; recomputing it from the mid-bias elements
        would leave the uninterrupted run), the transport cache is rebuilt
        from it, the saved unchanged-network record of the transport solve
        is kept, and the KMC clock continues."""
        cfg, params = self.cfg, self.params
        self._log("--------------------------------\n")
        self._log(f"Applied Voltage = {Vd:g} V\n")
        self._log("--------------------------------\n")

        chunk = cfg.solver_chunk_iters
        cold = resume_step == 0
        # cold bias-start solves run deflated; the in-superstep re-solves
        # keep cfg.boundary_precond
        cold_params = replace(self.params, boundary_precond="deflated")
        if params.solve_current:
            # no stored tunnel rows across a bias boundary or a restore, and
            # at a bias start no unchanged-network skip either: the CB edge is
            # solved anew, and it enters every tunnel entry
            self.state = replace(self.state, tt_valid=False)
            if cold:
                self.state = replace(self.state, transport_Vd_prev=float("nan"))

                def cb_edge():
                    if chunk > 0:
                        return self._chunked_cb_edge(Vd, chunk, cold_params)
                    self.state, m = self._cb_edge(cold_params, self.state, Vd)
                    return int(m["cg_iters_cb_edge"])

                dt = self._presolve("cb_edge", Vd, cb_edge)
                self._log(f"Z - calculation time - CB edge [s]: {dt:.6g}\n")
            if self.decomposition == "halo":
                # this rank's rows of the metal block, for the bias point
                self._cc = {"cc": self._halo_cc(self.params, self.state)}
            elif params.transport == "blocked":
                cache = _phase_transport_cache(self.geom, self.params, self.state)
                if self._band is not None:
                    cache["band"] = self._band
                self._cc = cache
        if params.solve_potential and cold:
            self._presolve("boundary", Vd, lambda: self._chunked_boundary(
                Vd, chunk if chunk > 0 else self.params.solver_maxiter, cold_params))
        if params.solve_current and chunk > 0 and cold and self.decomposition != "halo":
            # (the halo path has no cold transport pre-solve, as the JAX
            # package's has none)
            self._presolve("transport", Vd,
                           lambda: self._chunked_transport(Vd, chunk))

        folder = os.path.join(cfg.output_dir, f"Results_{Vd:.6f}")
        if self._writer:
            os.makedirs(folder, exist_ok=True)
        self._log(f"Created folder: {folder}\n")

        if cold:
            self.state = replace(self.state, kmc_time=0.0)
        I_macro = self.state.I_macro
        step_count = resume_step
        kmc_time = self.state.kmc_time
        summary: Dict = {}

        if cfg.batch_steps > 1 and self.fused and self.mesh is None:
            return self._run_bias_point_batched(Vd, t_end, folder, max_steps,
                                                resume_step)

        while kmc_time < t_end:
            t_start = time.perf_counter()
            self._log_step_start(step_count, Vd - I_macro * cfg.Rs)

            prev_state, step_time, metrics = self._step_with_redo(Vd)

            if step_count % cfg.log_freq == 0:
                self.write_snapshot(step_count, folder, elem_state=prev_state,
                                    field_state=self.state)
            self._sync()
            dt_step = time.perf_counter() - t_start

            if params.perturb_structure:
                kmc_time += step_time
            elif step_count > 10:
                # field-solver debug mode: force-end after 10 steps
                # (src/kmc_main.cpp:212-218)
                kmc_time = t_end
            self.state = replace(self.state, kmc_time=kmc_time)

            I_macro = self.state.I_macro
            summary = self._log_result(
                step_count, kmc_time, step_time,
                {k: float(v) for k, v in metrics.items()}, dt_step)

            if step_count % cfg.output_freq == 0:
                self._flush()
            step_count += 1
            self._pos = (self._pos[0], step_count)

            if I_macro > cfg.Icc * 1e-6:
                self._log("I_macro > Icc, compliance current reached.\n")
                break
            if max_steps is not None and step_count >= max_steps:
                break
            self._log("--------------------------------------\n")

        self.write_snapshot(step_count, folder)
        self._flush()
        summary["steps"] = step_count
        summary["kmc_time"] = kmc_time
        summary["completed"] = kmc_time >= t_end or I_macro > cfg.Icc * 1e-6
        return summary

    def _run_bias_point_batched(self, Vd: float, t_end: float, folder: str,
                                max_steps: Optional[int] = None,
                                resume_step: int = 0) -> Dict:
        """The main loop with ``batch_steps`` supersteps a batch
        (``superstep.multi_superstep_impl``), as the JAX package's
        ``Simulation._run_bias_point_batched``
        (``devicekmc_tpu/engine.py:1217-1361``): the time-window and
        compliance stops apply between the steps of a batch; every step is
        logged as the per-step driver logs it, V_vcm with the running
        I_macro (from each step's current) and the KMC time accumulated over
        the step times; a bucket that overflowed anywhere in a batch grows
        and the whole batch is redone from the state before it (five
        attempts); snapshot steps run alone through the per-step path, so
        that a snapshot pairs the elements before the events with the
        potentials after them (src/kmc_main.cpp:198-205).  A batch step's
        ``Z - calculation time - KMC superstep [s]`` is the batch's wall time
        over its steps.  A resumed bias point starts at ``resume_step``, and
        the snapshot steps stay the multiples of ``log_freq``."""
        cfg = self.cfg
        icc_A = cfg.Icc * 1e-6
        step_count = resume_step
        summary: Dict = {}
        kmc_time = self.state.kmc_time
        I_macro = self.state.I_macro
        lf = max(cfg.log_freq, 1)
        next_snap = -(-resume_step // lf) * lf

        while kmc_time < t_end:
            if max_steps is not None and step_count >= max_steps:
                break

            if step_count == next_snap:
                t0 = time.perf_counter()
                self._log_step_start(step_count, Vd - I_macro * cfg.Rs)
                prev_state, step_time, metrics = self._step_with_redo(Vd)
                self.write_snapshot(step_count, folder, elem_state=prev_state,
                                    field_state=self.state)
                self._sync()
                dt = time.perf_counter() - t0
                kmc_time += step_time
                self.state = replace(self.state, kmc_time=kmc_time)
                I_macro = self.state.I_macro
                summary = self._log_result(step_count, kmc_time, step_time,
                                           {k: float(v) for k, v in metrics.items()}, dt)
                self._log("--------------------------------------\n")
                step_count += 1
                next_snap += lf
                self._pos = (self._pos[0], step_count)
                self._flush()
                if I_macro > icc_A:
                    self._log("I_macro > Icc, compliance current reached.\n")
                    break
                continue

            # a batch, stopped at the next snapshot step
            lim = min(next_snap - step_count, cfg.batch_steps)
            if max_steps is not None:
                lim = min(lim, max_steps - step_count)
            t0 = time.perf_counter()
            kmc_start, I_start = kmc_time, I_macro
            _, step_times, ms = self._with_redo(
                lambda st: self._msuperstep(st, Vd, icc_A, t_end, lim),
                counts=self._batch_peaks)
            self._sync()
            dt_batch = time.perf_counter() - t0

            n_done = int(ms["active"].sum())
            kmc_time = self.state.kmc_time
            I_macro = self.state.I_macro
            I_hist = ms.get("Current [uA]")
            t_run, I_run = kmc_start, I_start
            for r in range(n_done):
                self._log_step_start(step_count, Vd - I_run * cfg.Rs)
                t_run += float(step_times[r])
                if I_hist is not None:
                    I_run = float(I_hist[r]) * 1e-6
                summary = self._log_result(
                    step_count, t_run, float(step_times[r]),
                    {k: float(v[r]) for k, v in ms.items() if k != "active"},
                    dt_batch / n_done)
                self._log("--------------------------------------\n")
                step_count += 1
            self._pos = (self._pos[0], step_count)
            self._flush()
            if I_macro > icc_A:
                self._log("I_macro > Icc, compliance current reached.\n")
                break

        self.write_snapshot(step_count, folder)
        self._flush()
        summary["steps"] = step_count
        summary["kmc_time"] = kmc_time
        summary["completed"] = kmc_time >= t_end or self.state.I_macro > icc_A
        return summary
