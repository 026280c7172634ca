"""The KMC superstep over a halo-exchange domain decomposition, the port of
``devicekmc_tpu/parallel/halo_superstep.py``.

Sites are split into contiguous x-slabs, one a rank (``mesh.Mesh``); every
per-site array lives only on its slab's rank, and every neighbour read
across a slab's edge goes through a fixed-width halo exchange with the
adjacent ranks.  The phases:

  * **charge** — one exchange of the packed site flags, gathered through
    the ELL-gather kernel (``ops.ell_gather``) into the halo window;
  * **boundary potential** — distributed Jacobi CG (``ops.cg.cg_solve``
    with every dot product summed over the ranks), warm-started from the
    last potential, so that an unchanged network takes 0 iterations;
  * **gridless Poisson** — each rank compacts its charged sites, one
    all-gather shares them, and each rank sweeps its rows over all of them
    with the exact-erfc sweep (``ops.pairwise.poisson_exact_batched``: the
    kernel on the card, the gathered slots compacted there and their count
    never read for the sweep);
  * **KMC events** — the residence-time loop with distributed selection:
    the ranks' 128-row block sums are all-gathered, every rank computes the
    same global cumsum and pick, the owner of the picked block resolves
    (row, slot) and the event, one all-reduce gives it to every rank, and
    each zeroes its conflicting pairs.  One all-gather and one all-reduce
    an event; the loop runs on the host, one read an event.

  * **transport and power** (``solve_current``, ``transport="blocked"``) —
    the blocked operator split over the ranks by rows, the CG vectors whole
    on every rank (``halo_transport.py``); each rank puts the atoms' power
    on its slab's sites;
  * **heat** — the global ODE on the whole power, or the matrix-free local
    model (``heat_solver="cg"``) on the slab.

The arithmetic is the single-device superstep's (the same charge rule, rate
law, block size and selection chain), so a halo run follows the single
device's trajectory up to CG round-off.

Requirements: graph bandwidth <= halo width <= slab size, and a slab a
multiple of ``events._BLOCK`` rows (``build_simulation(pad_to=...)``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import rng
from ..ops.compact import nonzero_fixed, nonzero_fixed_batched
from ..ops.ell_gather import _WORD_DTYPES, ell_gather
from ..ops.kmc_events import execute_event, event_type, time_draw
from ..ops.pairwise import poisson_exact_batched
from ..physics import charge as charge_mod
from ..physics import heat as heat_mod
from ..physics.events import _BLOCK, pack_site_code, rates_from_pairs
from ..physics.potential import _dirichlet_laplace_solve, _select, solve_cb_edge
from ..state import Geometry, PhysParams, SimState, _as_dtype, replace
from ..structure import Element
from .halo import compute_halo_width
from .halo_transport import halo_cc_rows, halo_heat_local_cg, halo_transport_power
from .mesh import Communicator, Mesh

_V = int(Element.VACANCY)
_OD = int(Element.OXYGEN_DEFECT)

#: the fields with one row a site: each rank keeps its slab of them; every
#: other field (the element and layer tables, the atom graph, the host
#: scalars) is kept whole on every rank
GEOM_SITE_FIELDS = (
    "coords", "neigh_idx", "neigh_valid", "v2_pair", "site_layer", "rev_slot", "io_idx",
    "io_fpos", "bp_left_mask", "bp_right_mask", "bp_interior_mask", "left_mask",
    "right_mask", "interior_mask", "inner_mask")
STATE_SITE_FIELDS = (
    "element", "charge", "potential_boundary", "potential_charge", "CB_edge", "power",
    "temperature", "cvac_prev", "boundary_r", "boundary_b")

_CHARGE_KEYS = ("Charged vacancies", "Uncharged vacancies", "Charged oxygen ions",
                "Uncharged oxygen ions")


def shard_halo_simulation(geom: Geometry, state: SimState, mesh: Mesh
                          ) -> Tuple[Geometry, SimState]:
    """This rank's slab ``[r·S, (r+1)·S)`` of every per-site field (copies on
    the rank's device) and the other fields whole.  ``neigh_idx`` keeps its
    global indices, and ``N`` stays the whole structure's.  The slabs run
    along the mesh's ``"sites"`` axis."""
    mesh = mesh.axis("sites")
    if geom.N % mesh.world:
        raise ValueError(f"{geom.N} sites do not split over {mesh.world} ranks (pad_to)")
    S = geom.N // mesh.world
    lo = mesh.rank * S

    def cut(rec, names):
        kw = {f: getattr(rec, f)[lo:lo + S].to(mesh.device, copy=True) for f in names}
        for f, v in vars(rec).items():
            if f not in kw and torch.is_tensor(v):
                kw[f] = v.to(mesh.device)
        return replace(rec, **kw)

    return cut(geom, GEOM_SITE_FIELDS), cut(state, STATE_SITE_FIELDS)


def shard_heat_model(heat: heat_mod.HeatModel, n_sites: int, mesh: Mesh
                     ) -> heat_mod.HeatModel:
    """This rank's slab of every field of the heat model with one row a
    site (the JAX package's ``site_axis_specs``), the others whole, on the
    rank's device."""
    mesh = mesh.axis("sites")
    S = n_sites // mesh.world
    lo = mesh.rank * S
    kw = {f: (v[lo:lo + S] if v.dim() and v.shape[0] == n_sites else v).to(mesh.device)
          for f, v in vars(heat).items() if torch.is_tensor(v)}
    return replace(heat, **kw)


# ----------------------------------------------------------------------------
# halo plumbing
# ----------------------------------------------------------------------------

class _Shard:
    """One rank's slab extent and its neighbour gather: a halo exchange and a
    gather at window-local indices into the [H + S + H] window.

    ``n_real`` (default: every site) is the structure's site count: the pad
    sites past it hold zeros in every vector of a solve, and the sums over
    the slab (:meth:`rows`, :meth:`pdot`) leave them out, so that at one
    rank a reduction runs over the single device's rows and rounds as its
    does."""

    def __init__(self, comm: Communicator, neigh_idx_local: torch.Tensor, halo: int,
                 n_real: Optional[int] = None):
        self.comm = comm
        self.H = halo
        self.S = neigh_idx_local.shape[0]
        self.idx = comm.rank
        self.gstart = self.idx * self.S
        n_real = comm.world * self.S if n_real is None else n_real
        self.n_rows = max(0, min(self.S, n_real - self.gstart))
        self.neigh_idx = neigh_idx_local
        self.valid = neigh_idx_local >= 0
        loc = neigh_idx_local.long() - (self.gstart - halo)
        # the gather kernel's plan: window-local indices, pad -1
        self.win_idx = torch.where(self.valid, loc, -1).to(torch.int32).contiguous()
        self.win_safe = self.win_idx.clamp(min=0).long()
        self.rows_gid = self.gstart + torch.arange(self.S, device=neigh_idx_local.device)

    def window(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.exchange(x, self.H)

    def gather(self, x: torch.Tensor, fill=0) -> torch.Tensor:
        """The neighbours' values [S, max_nn] of the slab ``x`` [S], ``fill``
        at pad slots: one exchange, then the ELL-gather kernel for a 32-bit
        ``x`` (its plain version for CPU tensors), plain indexing else (a
        bool ``x`` crosses as bytes)."""
        if x.dtype == torch.bool:
            return self.gather(x.to(torch.uint8), fill).bool()
        w = self.window(x)
        if w.dtype in _WORD_DTYPES:
            g = ell_gather(self.win_idx, [w])[0]
        else:
            g = w[self.win_safe]
        return torch.where(self.valid, g, fill)

    def gather_words(self, xs) -> list:
        """:meth:`gather` of up to two 32-bit slabs through one exchange of
        their bits and one launch of the gather (pad slots 0)."""
        packed = torch.stack([x.view(torch.int32) for x in xs], dim=1)
        w = self.window(packed)
        cols = [w[:, c].contiguous().view(x.dtype) for c, x in enumerate(xs)]
        return [torch.where(self.valid, g, 0) for g in ell_gather(self.win_idx, cols)]

    # the sums of a solve over the ranks (``physics.potential._OneDevice``'s)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The slab's rows of the structure, its pad rows left out."""
        return x[:self.n_rows]

    def psum(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.comm.all_reduce(t, op)

    def pdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a . b over the whole structure."""
        return self.comm.all_reduce(torch.dot(self.rows(a), self.rows(b)))


# ----------------------------------------------------------------------------
# the phases
# ----------------------------------------------------------------------------

def halo_charge(sh: _Shard, geom: Geometry, state: SimState) -> Tuple[SimState, Dict]:
    """The charge rule (``physics.charge``) on the slab; the counts summed
    over the ranks in one all-reduce."""
    is_vac, flags = charge_mod._flags(geom, state.element)
    state, m = charge_mod._apply_rule(geom, state, is_vac, sh.gather(flags))
    counts = sh.comm.all_reduce(torch.stack([m[k] for k in _CHARGE_KEYS]))
    return state, dict(zip(_CHARGE_KEYS, counts))


def halo_boundary(sh: _Shard, geom: Geometry, params: PhysParams, state: SimState,
                  Vd: float, maxiter: int, deflate_slabs: int = 0) -> Tuple[SimState, Dict]:
    """The boundary potential: conductance high_G for a (metal, metal) or
    (neutral vacancy, neutral vacancy) pair, contacts at -Vd/2 and +Vd/2,
    the distributed CG warm-started from ``potential_boundary`` (Jacobi, or
    deflated with ``deflate_slabs`` x-slabs: the cold pre-solve)."""
    dtype = params.dtype
    elem = state.element
    metal = geom.metal_mask_table[elem.long()]
    cvac = (elem == _V) & (state.charge == 0)
    nb_f2 = sh.gather((metal.to(torch.int32) << 1) | cvac.to(torch.int32))
    high = ((metal[:, None] & ((nb_f2 >> 1) > 0))
            | (cvac[:, None] & ((nb_f2 & 1) > 0)))
    edge_g = torch.where(sh.valid, _select(high, params.high_G, params.low_G, dtype), 0.0)
    Vd = _as_dtype(Vd, dtype)
    # the JAX package's _halo_dirichlet_laplace: the single device's solve on
    # the slab, the neighbours through the window, every sum over the ranks
    phi, res = _dirichlet_laplace_solve(
        geom, edge_g, _as_dtype(-Vd / 2.0, dtype), _as_dtype(Vd / 2.0, dtype),
        state.potential_boundary, params.solver_tol, maxiter,
        deflate_slabs=deflate_slabs, slab=sh)
    return (replace(state, potential_boundary=phi, cvac_prev=cvac, Vd_prev=Vd),
            {"cg_iters_boundary": res.iters, "boundary_converged": res.converged})


def halo_poisson(sh: _Shard, geom: Geometry, params: PhysParams, state: SimState,
                 block: int = 512) -> Tuple[SimState, int]:
    """The compacted gridless Poisson: each rank's first ``cap`` charged
    sites (coordinates, charge, global id) and its true count, packed in
    f64, through one all-gather; each rank sweeps its rows over every
    charged site, in ascending global order as the single device does.
    Returns the state and the global charged count (the engine redoes the
    step when it exceeds the cap)."""
    dtype = params.dtype
    cap = max(params.poisson_compact_cap, 1)
    cdtype = torch.float32 if params.mixed else dtype
    cidx, n_l = nonzero_fixed(state.charge != 0, cap, fill_value=0)
    dev = cidx.device
    slot_ok = torch.arange(cap, device=dev) < n_l
    cl = cidx.long()
    packed = torch.cat([
        geom.coords[cl].to(cdtype).to(torch.float64),
        torch.where(slot_ok, state.charge[cl], 0).to(torch.float64)[:, None],
        torch.where(slot_ok, sh.gstart + cl, -1).to(torch.float64)[:, None],
    ], dim=1)
    tail = torch.zeros(1, 5, dtype=torch.float64, device=dev)
    tail[0, 0] = n_l
    g = sh.comm.all_gather(torch.cat([packed, tail])).reshape(sh.comm.world, cap + 1, 5)
    slots = g[:, :cap].reshape(-1, 5)
    # the filled slots, compacted on the device: the exact sweep's sources
    # and their count, which the host does not read
    sel, count = nonzero_fixed_batched((slots[:, 4] >= 0)[None], slots.shape[0])
    src = slots[sel[0].long()]
    lat = [_as_dtype(x, cdtype) for x in geom.lattice_host]
    v = poisson_exact_batched(
        geom.coords.to(cdtype).contiguous(), sh.gstart,
        src[None, :, :3].to(cdtype).contiguous(), src[None, :, 4].to(torch.int32).contiguous(),
        src[None, :, 3].to(cdtype).contiguous(), count, lat,
        _as_dtype(params.sigma, cdtype), _as_dtype(params.k, cdtype), geom.pbc,
        n_sweep=sh.comm.world * sh.S, block=block)[0]
    n_charged = int(g[:, cap, 0].sum())
    return replace(state, potential_charge=v.to(dtype)), n_charged


_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _halo_event_loop(sh: _Shard, geom: Geometry, params: PhysParams, element, charge,
                     phi_b, phi_c, T_bg: float, key: rng.Key):
    """The residence-time loop over the ranks' slabs, one all-gather (the
    block sums) and one all-reduce (the event) an event, the stop condition
    read from them on every rank alike.  The selection chain is the single
    device's: block sums -> row sums -> slots, f64 sums, ``_BLOCK`` rows a
    block; the picked pair's rows and every pair naming i or j are zeroed
    and the touched row sums recomputed from the zeroed table.  Returns
    (element, charge, key, event_time, count)."""
    comm = sh.comm
    S, m = sh.neigh_idx.shape
    nb_l = S // _BLOCK
    n_blocks = nb_l * comm.world
    H, W = sh.H, sh.S + 2 * sh.H
    rdtype = torch.float32 if params.mixed else params.dtype
    acc = torch.float64

    phi = (phi_b + phi_c).to(rdtype)
    code = pack_site_code(element, charge, geom.site_layer)
    if rdtype == torch.float32:
        phi_j, code_j = sh.gather_words([phi, code])
    else:
        phi_j, code_j = sh.gather(phi, fill=0.0), sh.gather(code)
    prob = rates_from_pairs(params, geom.layer_E, T_bg, element, charge, phi,
                            geom.site_layer, phi_j, code_j, geom.v2_pair, sh.valid)
    row_sums = prob.to(acc).sum(dim=1)
    block_sums = row_sums.reshape(nb_l, _BLOCK).sum(dim=1)

    element, charge = element.clone(), charge.clone()
    # (element, charge) of the window, kept current event by event
    ec_w = sh.window(torch.stack([element, charge], dim=1))
    lo_w = sh.gstart - H
    t_window = 1.0 / params.freq
    event_time, count = 0.0, 0
    while event_time < t_window and count < params.max_events_per_superstep:
        key, k_sel, k_time = rng.split(key, 3)
        u = rng.uniform(k_sel, np.float64)

        # --- the global selection, computed alike on every rank; the owner
        # of the picked block resolves its row and slot ---
        block_cum = torch.cumsum(comm.all_gather(block_sums), dim=0)
        psum = block_cum[-1]
        target = (u * psum).reshape(1)
        blk = torch.clamp(torch.searchsorted(block_cum, target, right=True)[0],
                          max=n_blocks - 1)
        mine = (blk // nb_l) == sh.idx
        base_b = torch.where(blk > 0, block_cum[(blk - 1).clamp(min=0)], 0.0)
        lblk = torch.clamp(blk - sh.idx * nb_l, 0, nb_l - 1)
        row_cum = torch.cumsum(row_sums.reshape(nb_l, _BLOCK)[lblk], dim=0)
        r_in = torch.clamp(torch.searchsorted(row_cum, target - base_b, right=True)[0],
                           max=_BLOCK - 1)
        r = torch.clamp(lblk * _BLOCK + r_in, max=S - 1)
        base_r = torch.where(r_in > 0, row_cum[(r_in - 1).clamp(min=0)], 0.0)
        slot_cum = torch.cumsum(prob[r].to(acc), dim=0)
        s = torch.clamp(
            torch.searchsorted(slot_cum, target - base_b - base_r, right=True)[0], max=m - 1)
        i_g = sh.gstart + r
        j_g = sh.neigh_idx[r, s].long()
        ok = (psum > 0) & (prob[r, s] > 0)
        wi = torch.clamp(i_g - lo_w, 0, W - 1)
        wj = torch.clamp(j_g - lo_w, 0, W - 1)
        msg = torch.stack([v.to(torch.float64) for v in (
            i_g, j_g, ec_w[wi, 0], ec_w[wj, 0], ec_w[wi, 1], ec_w[wj, 1], ok)])
        msg = comm.all_reduce(torch.where(mine, msg, 0.0))
        *ev_h, psum_h = torch.cat([msg, psum.reshape(1).to(torch.float64)]).tolist()
        i, j, e_i, e_j, q_i, q_j, valid = (int(v) for v in ev_h)
        if not valid:
            event_time = float("inf")
            break

        # --- the event on the slab and on the window ---
        el, ch = {i: e_i, j: e_j}, {i: q_i, j: q_j}
        execute_event(el, ch, i, j, e_i, e_j, q_i, q_j, event_type(e_i, e_j))
        for site in (i, j):
            if 0 <= site - sh.gstart < S:
                element[site - sh.gstart] = el[site]
                charge[site - sh.gstart] = ch[site]
            if 0 <= site - lo_w < W:
                ec_w[site - lo_w, 0] = el[site]
                ec_w[site - lo_w, 1] = ch[site]

        # --- conflict zeroing over the slab ---
        nb = sh.neigh_idx
        rows = sh.rows_gid[:, None]
        conflict = (rows == i) | (rows == j) | (nb == i) | (nb == j)
        prob.masked_fill_(conflict, 0.0)
        row_sums = torch.where(conflict.any(dim=1), prob.to(acc).sum(dim=1), row_sums)
        block_sums = row_sums.reshape(nb_l, _BLOCK).sum(dim=1)

        u_t = rng.uniform(k_time, _NP[rdtype])
        event_time = time_draw(params.dtype, rdtype, u_t, psum_h)
        count += 1
    return element, charge, key, event_time, count


# ----------------------------------------------------------------------------
# the superstep
# ----------------------------------------------------------------------------

def halo_power(sh: _Shard, geom: Geometry, params: PhysParams, state: SimState, Vd: float,
               ts, sizes, cc=None) -> Tuple[SimState, Dict]:
    """Phase 5: the transport solve and the power over the ranks
    (``halo_transport.halo_transport_power``), the atoms' power put on this
    rank's sites through ``site_atom``.  ``cc``: the bias point's
    ``{"cc": rows}`` of :func:`halo_transport.halo_cc_rows`."""
    vp, I_macro, atom_power, P_tot, metrics = halo_transport_power(
        sh, geom, params, ts, sizes, state.element, state.charge, state.CB_edge,
        state.virtual_potentials, Vd, T_cc_loc=(cc or {}).get("cc"))
    sa = ts["site_atom"]
    power = torch.where(sa >= 0, atom_power[sa.clamp(min=0).long()], 0.0).to(params.dtype)
    return replace(state, virtual_potentials=vp, I_macro=I_macro, P_tot=P_tot,
                   power=power), metrics


def halo_heat(sh: _Shard, geom: Geometry, params: PhysParams, heat, state: SimState,
              step_time: float) -> Tuple[SimState, Dict]:
    """Phase 6: the global ODE on the whole power (it takes precedence, as
    ``heat.update_temperature`` has it), or the matrix-free local model on
    the slab (``halo_transport.halo_heat_local_cg``)."""
    if params.solve_heating_global:
        T_bg = heat_mod.global_ode(params, state.T_bg, state.P_tot, step_time)
        return replace(state, T_bg=T_bg), {"Global temperature [K]": T_bg}
    if params.solve_heating_local and heat is not None and heat.n_interface:
        temp, T_bg, m = halo_heat_local_cg(sh, geom, params, heat, state.element,
                                           state.power, state.temperature, step_time)
        return replace(state, temperature=temp, T_bg=T_bg), m
    return state, {}


def _halo_superstep_body(sh: _Shard, geom: Geometry, params: PhysParams, state: SimState,
                         Vd: float, heat=None, ts=None, sizes=None, cc=None
                         ) -> Tuple[SimState, float, Dict]:
    """The superstep on this rank's slab: charge, boundary potential,
    gridless Poisson, KMC events, and with ``solve_current`` transport and
    power, then heat.  Every metric is the whole structure's, the same on
    every rank."""
    metrics: Dict = {}
    if params.solve_potential:
        state, m = halo_charge(sh, geom, state)
        metrics.update(m)
        state, m = halo_boundary(sh, geom, params, state, Vd, params.solver_maxiter)
        metrics.update(m)
        state, metrics["n_charged_sites"] = halo_poisson(sh, geom, params, state)
    else:
        cvac = (state.element == _V) & (state.charge == 0)
        state = replace(state, cvac_prev=cvac, Vd_prev=_as_dtype(Vd, params.dtype))

    step_time, n_events = 0.0, 0
    if params.perturb_structure:
        element, charge, key, step_time, n_events = _halo_event_loop(
            sh, geom, params, state.element, state.charge, state.potential_boundary,
            state.potential_charge, state.T_bg, state.key)
        state = replace(state, element=element, charge=charge, key=key,
                        kmc_time=state.kmc_time + step_time)

    if params.solve_current:
        state, m = halo_power(sh, geom, params, state, Vd, ts, sizes, cc)
        metrics.update(m)
        state, m = halo_heat(sh, geom, params, heat, state, step_time)
        metrics.update(m)
    metrics["n_events"] = n_events
    return state, step_time, metrics


def check_halo_config(params: PhysParams, heat_method: Optional[str]) -> None:
    """Raise where the JAX package's halo path raises for a configuration it
    cannot split: dense transport, and local heat with the dense model
    (``heat_method``: the heat model's method, None without one)."""
    if params.solve_current and params.transport != "blocked":
        raise ValueError("halo transport requires transport='blocked' (the dense X matrix "
                         "cannot shard); set transport = blocked")
    if params.solve_heating_local and heat_method != "cg":
        raise ValueError("halo local heating requires the matrix-free model: set "
                         "heat_solver = cg (the dense interface inverse cannot shard)")


def make_halo_superstep(geom: Geometry, params: PhysParams, heat, mesh: Mesh, halo: int,
                        ts=None, sizes=None):
    """The superstep of this rank over the halo decomposition, for the slab
    geometry of :func:`shard_halo_simulation`: ``superstep(state, Vd,
    cc=None) -> (state, step_time, metrics)``, the contract of
    ``engine.make_superstep``, run by every rank in step.  With
    ``solve_current`` the blocked transport runs split over the ranks
    (``ts``, ``sizes``: ``halo_transport.build_transport_static``'s, required)
    and ``cc`` carries the bias point's metal-block rows
    (:func:`make_halo_cc_cache`); ``heat``: this rank's slab of the heat model
    (:func:`shard_heat_model`).  Its ``charge(state)``, ``boundary(state, Vd,
    maxiter, deflate_slabs=0)`` and ``cb_edge(state, Vd, params)`` (the CB
    edge on the slabs, deflated as ``params.boundary_precond`` says) are
    those phases alone (the engine's cold pre-solves).

    Raises ValueError where the JAX package raises: dense transport, local
    heat without ``heat_solver="cg"``, no static tables, a halo wider than
    the slab, a slab that is not a whole number of blocks,
    ``poisson_compact_cap <= 0``."""
    check_halo_config(params, None if heat is None else heat.method)
    if params.solve_current and (ts is None or sizes is None):
        raise ValueError("halo transport needs the static tables from "
                         "halo_transport.build_transport_static")
    mesh = mesh.axis("sites")
    S = geom.neigh_idx.shape[0]
    if S * mesh.world != geom.N:
        raise ValueError("the geometry is not this rank's slab (shard_halo_simulation)")
    if halo > S:
        raise ValueError(f"halo width {halo} exceeds slab size {S}: use fewer ranks or a "
                         "bandwidth-reducing site order (site_order = x)")
    if S % _BLOCK:
        raise ValueError(f"slab size {S} is not a multiple of events._BLOCK = {_BLOCK} "
                         "(pad_to)")
    if params.solve_potential and params.poisson_compact_cap <= 0:
        raise ValueError("halo decomposition requires a positive poisson_compact_cap (the "
                         "dense O(N^2) sweep is replaced by the compacted gather)")
    sh = _Shard(mesh.comm, geom.neigh_idx, halo, geom.N_real)

    def superstep(state: SimState, Vd: float, cc=None):
        return _halo_superstep_body(sh, geom, params, state, Vd, heat, ts, sizes, cc)

    superstep.charge = lambda state: halo_charge(sh, geom, state)
    superstep.boundary = lambda state, Vd, maxiter, deflate_slabs=0: halo_boundary(
        sh, geom, params, state, Vd, maxiter, deflate_slabs)
    superstep.cb_edge = lambda state, Vd, p=params: solve_cb_edge(geom, p, state, Vd, slab=sh)
    return superstep


def make_halo_cc_cache(geom: Geometry, mesh: Mesh, ts, sizes):
    """The bias point's metal-block cache of the halo transport (``current.
    assemble_transport_cache`` over the ranks): ``fn(params, state) ->`` this
    rank's ``[Smp, n_mp_pad]`` rows of the metal_p x metal_p block, for
    ``cc={"cc": rows}`` (valid while the CB edge is: a bias point)."""
    mesh = mesh.axis("sites")

    def build(params: PhysParams, state: SimState) -> torch.Tensor:
        return halo_cc_rows(geom, params, mesh.comm, ts, sizes, state.element, state.charge,
                            state.CB_edge)

    return build


def required_halo(geom_or_neigh) -> int:
    """Graph bandwidth of the (global) neighbour list."""
    nb = geom_or_neigh.neigh_idx if hasattr(geom_or_neigh, "neigh_idx") else geom_or_neigh
    return compute_halo_width(nb)
