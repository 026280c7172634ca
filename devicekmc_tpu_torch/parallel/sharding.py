"""The replicated decomposition of the KMC superstep over a mesh of ranks,
the port of ``devicekmc_tpu/parallel/sharding.py`` (what
``Simulation(mesh=...)`` runs by default).

The JAX package places its arrays (the pair arrays split by site row, the
field vectors replicated) and lets XLA's partitioner insert the
collectives.  torch has no partitioner, so this module writes out what that
placement asks for, one process a device (``mesh.Mesh``):

  * **Layout.** The site axis is padded to a multiple of the world size
    (``build_simulation(pad_to=world)``), and rank r owns the rows ``[r·S,
    (r+1)·S)``, ``S = N / world``, of the pair arrays ``neigh_valid`` and
    ``v2_pair`` (:func:`shard_simulation`), and of the ELL values of the
    boundary and CB-edge systems, which each solve assembles.  Every
    ``SimState`` field and every vector-sized table is whole on every rank,
    and so are ``neigh_idx`` and ``rev_slot``: the event loop's conflict
    zeroing reads whole rows of both.
  * **Work split by rows.** The phases that read pair arrays work on the
    rank's rows, and one all-gather makes their output whole again: the
    charge rule (the counts through one all-reduce); the boundary system's
    assembly and its CG, whose matvec all-gathers the direction and whose
    dots are all-reduced partial sums; the compacted Poisson sweep, the
    rank's rows against the whole charged list (on the card the row range
    of ``ops.pairwise.poisson_exact_batched`` or of
    ``poisson_pairwise_rows``), which every rank holds; the rate
    table's rows.  The exact skip and the incremental residual run on every
    rank alike: they read the whole state and the changed rows only.  The
    boundary solve and the sweep are the single device's functions given
    the rank's rows (``rows=``), as the CB-edge solve is given a slab.
  * **The event loop.** The table's rows are all-gathered once a superstep
    (a compacted table: each rank's slots summed, one all-reduce); then every
    rank computes the block sums over the whole table and runs the single
    device's event loop (``ops.kmc_events``, one launch on the card) over it
    with the same key, so each applies the same events to its whole state,
    and no collective runs inside the loop.
  * **Whole on every rank, no collective.** Transport, power extraction,
    heat, and the cold transport solve run the single device's code and
    kernels on the whole state, as XLA runs a Pallas call it cannot
    partition.  Under a mesh the engine builds no band and keeps no
    persistent tunnel store (as ``devicekmc_tpu/engine.py`` does).

Every rank ends each superstep with the same bits: every collective hands
each rank the same values, and each then computes alike.  The sums over a
rank's rows skip its pad rows (``halo_superstep._Shard.rows``), so that at a
world of one rank every sum is the single device's and the decomposition is
the single device's eager superstep bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.ell_gather import _WORD_DTYPES, ell_gather
from ..physics import charge as charge_mod
from ..physics import events as events_mod
from ..physics.potential import solve_cb_edge
from ..state import Geometry, PhysParams, SimState, replace
from ..superstep import _phase_boundary, _phase_heat, _phase_poisson, _phase_power
from .halo_superstep import GEOM_SITE_FIELDS, _Shard
from .mesh import Mesh

#: the geometry's pair arrays: each rank keeps its rows of them
GEOM_ROW_FIELDS = ("neigh_valid", "v2_pair")

_CHARGE_KEYS = ("Charged vacancies", "Uncharged vacancies", "Charged oxygen ions",
                "Uncharged oxygen ions")


def row_range(n_sites: int, mesh: Mesh) -> Tuple[int, int]:
    """(first row, rows) of this rank along the mesh's ``"sites"`` axis:
    ``[r·S, (r+1)·S)``, ``S = n_sites / W`` for W ranks along it."""
    mesh = mesh.axis("sites")
    if n_sites % mesh.world:
        raise ValueError(f"{n_sites} sites do not split over {mesh.world} ranks "
                         "(build_simulation(pad_to=world))")
    S = n_sites // mesh.world
    return mesh.rank * S, S


def shard_simulation(geom: Geometry, state: SimState, mesh: Mesh
                     ) -> Tuple[Geometry, SimState]:
    """Place the geometry and the state on the mesh's device: this rank's rows
    of the pair arrays (``GEOM_ROW_FIELDS``, copies) along the mesh's
    ``"sites"`` axis, every other field whole."""
    lo, S = row_range(geom.N, mesh)
    kw = {f: getattr(geom, f)[lo:lo + S].to(mesh.device, copy=True) for f in GEOM_ROW_FIELDS}
    for f, v in vars(geom).items():
        if f not in kw and torch.is_tensor(v):
            kw[f] = v.to(mesh.device)
    geom = replace(geom, **kw)
    state = replace(state, **{f: v.to(mesh.device) for f, v in vars(state).items()
                              if torch.is_tensor(v)})
    return geom, state


class _Rows(_Shard):
    """One rank's rows ``[gstart, gstart + S)`` of the structure, with the
    interface of a halo slab (``halo_superstep._Shard``: ``gather``,
    ``rows``, ``psum``, ``pdot``, ``window``, ``win_safe``), so that the
    single device's solver runs on the rows: a neighbour read of a vector of
    a solve (the rank's rows) all-gathers it.  ``geom`` is the rows'
    geometry: every per-site field cut to the rows, ``neigh_idx`` with its
    global indices."""

    def __init__(self, geom: Geometry, mesh: Mesh):
        mesh = mesh.axis("sites")
        if geom.neigh_valid.shape[0] * mesh.world != geom.N:
            raise ValueError("the geometry is not this rank's (shard_simulation)")
        lo, S = row_range(geom.N, mesh)
        self.comm = mesh.comm
        self.S, self.idx, self.gstart = S, mesh.rank, lo
        self.n_rows = max(0, min(S, geom.N_real - lo))
        self.sl = slice(lo, lo + S)
        nb = geom.neigh_idx[self.sl].contiguous()
        self.neigh_idx = self.win_idx = nb
        self.valid = geom.neigh_valid
        self.win_safe = nb.clamp(min=0).long()
        kw = {f: getattr(geom, f)[self.sl] for f in GEOM_SITE_FIELDS
              if f not in GEOM_ROW_FIELDS + ("neigh_idx",)}
        self.geom = replace(geom, neigh_idx=nb, **kw)

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """The whole vector of the ranks' rows ``x``: one all-gather."""
        return self.comm.all_gather(x)

    def gather(self, x: torch.Tensor, fill=0) -> torch.Tensor:
        """The neighbours' values [S, max_nn] of the rows' vector ``x`` [S],
        ``fill`` at pad slots: one all-gather, then the ELL-gather kernel for
        a 32-bit ``x`` (its plain version for CPU tensors), plain indexing
        else (a bool ``x`` crosses as bytes)."""
        if x.dtype == torch.bool:
            return self.gather(x.to(torch.uint8), fill).bool()
        w = self.window(x)
        g = ell_gather(self.win_idx, [w])[0] if w.dtype in _WORD_DTYPES else w[self.win_safe]
        return torch.where(self.valid, g, fill)

    def whole(self, *xs: torch.Tensor):
        """The whole vectors of the ranks' rows ``xs`` (each [S], one dtype),
        through one all-gather."""
        if len(xs) == 1:
            return self.window(xs[0])
        g = self.window(torch.stack(xs, dim=1))
        return tuple(g[:, k].contiguous() for k in range(len(xs)))


# ----------------------------------------------------------------------------
# the phases
# ----------------------------------------------------------------------------

def replicate_charge(rg: _Rows, geom: Geometry, state: SimState) -> Tuple[SimState, Dict]:
    """The charge rule (``physics.charge``) on the rank's rows, the flags of
    the whole state gathered through the ELL-gather kernel; the charges made
    whole by one all-gather, the counts summed by one all-reduce."""
    is_vac, flags = charge_mod._flags(geom, state.element)
    sl = rg.sl
    rows = replace(state, element=state.element[sl], charge=state.charge[sl])
    nb_flags = ell_gather(rg.win_idx, [flags])[0]
    rows, m = charge_mod._apply_rule(rg.geom, rows, is_vac[sl], nb_flags)
    counts = rg.comm.all_reduce(torch.stack([m[k] for k in _CHARGE_KEYS]))
    return replace(state, charge=rg.whole(rows.charge)), dict(zip(_CHARGE_KEYS, counts))


def replicate_boundary(rg: _Rows, geom: Geometry, params: PhysParams, state: SimState,
                       Vd: float) -> Tuple[SimState, Dict]:
    """The boundary potential over the ranks (``potential.
    solve_boundary_potential`` with the rank's rows)."""
    return _phase_boundary(geom, params, state, Vd, rows=rg)


def replicate_poisson(rg: _Rows, geom: Geometry, params: PhysParams, state: SimState
                      ) -> Tuple[SimState, Dict]:
    """The compacted Poisson sweep over the ranks (``potential.
    poisson_gridless_compact`` with the rank's rows: the row range of the
    exact kernel with ``poisson_kernel = "jnp"``, of the pair-sweep kernel
    with ``"pallas"``; either splits its sources as the whole sweep does, so
    each row is the single device's bit for bit)."""
    return _phase_poisson(geom, params, state, rows=rg)


def _rate_rows(geom: Geometry, params: PhysParams, state: SimState, rows, nb, valid, v_pair):
    """``events.build_rate_table``'s rows at the sites ``rows`` (a slice or
    int64 indices), whose neighbour lists are ``nb`` (int32, global
    indices), pair validity ``valid`` and Coulomb kernel ``v_pair``."""
    dtype = torch.float32 if params.mixed else params.dtype
    phi = (state.potential_boundary + state.potential_charge).to(dtype)
    code = events_mod.pack_site_code(state.element, state.charge, geom.site_layer)
    if dtype == torch.float32:
        phi_j, code_j = ell_gather(nb, [phi.contiguous(), code.contiguous()])
    else:
        safe = nb.clamp(min=0).long()
        phi_j, code_j = phi[safe], code[safe]
    return events_mod.rates_from_pairs(
        params, geom.layer_E, state.T_bg, state.element[rows], state.charge[rows], phi[rows],
        geom.site_layer[rows], phi_j, code_j, v_pair, valid)


def replicate_rate_table(rg: _Rows, geom: Geometry, params: PhysParams, state: SimState,
                         active_idx=None) -> torch.Tensor:
    """``events.build_rate_table`` over the ranks: each rank computes the
    table's rows of its sites and one collective makes the table whole on
    every rank (an all-gather of the rows; for the compacted rows
    ``active_idx``, whose sites may fall on any rank, each rank's rows put
    in their slots of a zero table and the tables summed by one all-reduce,
    each slot then holding one rank's row)."""
    dev = geom.device
    if active_idx is None:
        part = _rate_rows(geom, params, state, rg.sl, rg.win_idx, rg.valid, geom.v2_pair)
        return rg.window(part)
    a = active_idx.long()
    mine = torch.nonzero((a >= rg.gstart) & (a < rg.gstart + rg.S)).reshape(-1)
    sites = a[mine]
    loc = sites - rg.gstart
    part = _rate_rows(geom, params, state, sites, geom.neigh_idx[sites].contiguous(),
                      geom.neigh_valid[loc], geom.v2_pair[loc])
    table = torch.zeros((a.shape[0], geom.max_nn), dtype=part.dtype, device=dev)
    table[mine] = part
    return rg.comm.all_reduce(table)


def replicate_events(rg: _Rows, geom: Geometry, params: PhysParams, state: SimState):
    """The KMC superstep (``events.execute_superstep``) on every rank alike:
    the whole rate table from :func:`replicate_rate_table`, then the single
    device's event loop over it."""
    return events_mod.execute_superstep(
        geom, params, state,
        rate_table=lambda g, p, st, active_idx=None: replicate_rate_table(rg, g, p, st,
                                                                          active_idx))


def replicate_power(geom: Geometry, params: PhysParams, state: SimState, Vd: float, cc=None):
    """Transport and power: the single device's solve on every rank."""
    return _phase_power(geom, params, state, Vd, cc)


def replicate_heat(geom: Geometry, params: PhysParams, heat, state: SimState, step_time):
    """Heat: the single device's model on every rank."""
    return _phase_heat(geom, params, heat, state, step_time)


# ----------------------------------------------------------------------------
# the superstep
# ----------------------------------------------------------------------------

def _sharded_superstep_body(rg: _Rows, geom: Geometry, params: PhysParams, heat,
                            state: SimState, Vd: float, cc=None
                            ) -> Tuple[SimState, float, Dict]:
    """``superstep.superstep_impl``'s phases over the ranks, in its order."""
    metrics: Dict = {}
    if params.solve_potential:
        state, m = replicate_charge(rg, geom, state)
        metrics.update(m)
        state, m = replicate_boundary(rg, geom, params, state, Vd)
        metrics.update(m)
        state, m = replicate_poisson(rg, geom, params, state)
        metrics.update(m)

    step_time = 0.0
    if params.perturb_structure:
        res = replicate_events(rg, geom, params, state)
        state, step_time = res.state, res.step_time
        metrics["n_events"] = res.n_events
        metrics["n_active_rows"] = res.n_active

    if params.solve_current:
        state, m = replicate_power(geom, params, state, Vd, cc)
        metrics.update(m)
        if params.solve_heating_global or params.solve_heating_local:
            state, m = replicate_heat(geom, params, heat, state, step_time)
            metrics.update(m)
    return state, step_time, metrics


def make_sharded_superstep(geom: Geometry, params: PhysParams, heat, mesh: Mesh):
    """The superstep of this rank over the replicated decomposition, for the
    geometry and state of :func:`shard_simulation`: ``superstep(state, Vd,
    cc=None) -> (state, step_time, metrics)``, the contract of
    ``engine.make_superstep``, run eagerly by every rank in step; every rank
    returns the same state and metrics.  ``mesh``: a mesh with a
    ``"sites"`` axis (on a 2-D mesh its ``"sites"`` view runs the rows).
    ``cc``: the bias point's transport cache
    (``current.assemble_transport_cache``), whole on every rank;
    ``heat``: the heat model, whole.  Its ``charge(state)`` and
    ``boundary(geom, params, state, Vd)`` (``superstep._phase_boundary``'s
    signature) are those phases alone, for the engine's cold pre-solve."""
    rg = _Rows(geom, mesh)

    def superstep(state: SimState, Vd: float, cc=None):
        return _sharded_superstep_body(rg, geom, params, heat, state, Vd, cc)

    superstep.charge = lambda state: replicate_charge(rg, geom, state)
    superstep.boundary = lambda g, p, state, Vd: replicate_boundary(rg, geom, p, state, Vd)
    superstep.rows = rg
    return superstep


def solve_cb_edge_sharded(geom: Geometry, params: PhysParams, state: SimState, Vd: float,
                          mesh: Mesh, rows: _Rows = None) -> Tuple[SimState, Dict]:
    """The CB-edge solve (``potential.solve_cb_edge``) over the ranks: the
    rank's rows of the system and the single device's CG on them, the edge
    made whole by one all-gather.  ``rows``: the superstep's :class:`_Rows`
    (made anew without it)."""
    rg = rows or _Rows(geom, mesh)
    sl = rg.sl
    part, m = solve_cb_edge(rg.geom, params,
                            replace(state, element=state.element[sl], CB_edge=state.CB_edge[sl]),
                            Vd, slab=rg)
    return replace(state, CB_edge=rg.whole(part.CB_edge)), m


def row_bytes(geom: Geometry, world: int) -> Dict[str, int]:
    """Bytes a rank of ``world`` holds of the arrays with ``max_nn`` slots a
    site row: its rows of the pair arrays (``GEOM_ROW_FIELDS``) and of a
    solve's two ELL value arrays (conductances and negated values, in
    ``v2_pair``'s dtype), and the whole ``neigh_idx`` and ``rev_slot``;
    beside them what one device holds of the same arrays.  ``geom``: the
    whole structure's geometry (or a rank's: only dtypes and sizes are
    read)."""
    S = -(-geom.N // world)
    m = geom.max_nn
    pair = sum(getattr(geom, f).element_size() for f in GEOM_ROW_FIELDS) * m
    solve = 2 * geom.v2_pair.element_size() * m
    whole = sum(getattr(geom, f).element_size() for f in ("neigh_idx", "rev_slot")) * m * geom.N
    return {"pair_rows": pair * S, "solve_rows": solve * S, "neigh_idx_rev_slot": whole,
            "rank": (pair + solve) * S + whole, "single_device": (pair + solve) * geom.N + whole}


__all__ = ["shard_simulation", "make_sharded_superstep", "solve_cb_edge_sharded", "row_bytes",
           "GEOM_ROW_FIELDS"]
