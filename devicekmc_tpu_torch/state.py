"""Simulation state: explicit dataclasses of tensors.

Three records, as in ``devicekmc_tpu.state``:

* :class:`Geometry`  — static per-run tensors (coordinates, ELL neighbour
  graph, pair distances and Coulomb kernels, layer tables, masks) plus the
  static sizes.  Never changed after construction.
* :class:`PhysParams` — scalar physics parameters (Python floats holding the
  working dtype's value) and the static configuration.
* :class:`SimState`  — everything that evolves.  Per-site fields are tensors
  on the run's device; scalars (clock, bias of the last boundary solve, the
  threefry key) are host numbers, because the engine reads them every step.

Every phase returns a new :class:`SimState` (``dataclasses.replace``) and
never writes into a tensor it was given, so the engine may keep the previous
state to redo a step.

A *batched* state (``parallel.batched``) is a :class:`SimState` of B replicas
of one geometry, as the JAX package batches its pytree: every tensor field
has a leading [B] axis, and the host scalars are device tensors, so that no
replica's decision needs a host read: ``key`` [B, 2] uint32, ``tt_valid`` [B]
bool, the others [B] float64 (:func:`stack_states`, :func:`unbatch`).
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import constants as C
from . import rng
from .config import KMCConfig
from .device import resolve_device
from .structure import (
    Element,
    NON_ATOM_ELEMENTS,
    assign_layers,
    build_neighbor_list,
)

replace = dataclasses.replace


@dataclass
class Geometry:
    coords: torch.Tensor            # [N,3] float   site positions [Angstrom]
    neigh_idx: torch.Tensor         # [N,max_nn] int32, pad -1, rows ascending
    neigh_valid: torch.Tensor       # [N,max_nn] bool
    v2_pair: torch.Tensor           # [N,max_nn] float  erfc(r/(sigma*sqrt2))*k*q/r [V]
    site_layer: torch.Tensor        # [N] int32
    metal_mask_table: torch.Tensor  # [n_elements] bool
    layer_E: torch.Tensor           # [n_layers, 4] float
    rev_slot: torch.Tensor          # [N,max_nn] int32: slot of i in row neigh_idx[i,s]
    io_idx: torch.Tensor            # [N] int32: internal index of file position p
                                    # (pad sites: positions from N_real on)
    io_fpos: torch.Tensor           # [N] int32: file position of internal site k
    bp_left_mask: torch.Tensor      # [N] bool: boundary-potential Dirichlet masks
    bp_right_mask: torch.Tensor     # [N] bool
    bp_interior_mask: torch.Tensor  # [N] bool
    left_mask: torch.Tensor         # [N] bool: CB-edge Dirichlet masks (first layer)
    right_mask: torch.Tensor        # [N] bool
    interior_mask: torch.Tensor     # [N] bool
    inner_mask: torch.Tensor        # [N] bool: file positions [num_atoms_contact, N - nac):
                                    # the region the local heat model averages T_bg over
    atom_ind: torch.Tensor          # [N_atom] int32: site of atom slot a (FILE order)
    atom_metalp_idx: torch.Tensor   # [n_mp] int32: atom slots of the interior metals
    atom_metalp_inv: torch.Tensor   # [N_atom] int32: slot in atom_metalp_idx, -1 else
    atom_neigh_idx: torch.Tensor    # [N_atom,max_nn] int32: neigh_idx in atom slots, pad -1
    N: int = 0                      # sites, pad sites included
    max_nn: int = 0
    N_atom: int = 0
    pbc: bool = False
    N_real: int = 0                 # sites of the structure: N less the pad sites
    lattice_host: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def device(self) -> torch.device:
        return self.neigh_idx.device


@dataclass
class PhysParams:
    freq: float
    sigma: float              # [m]
    k: float                  # Coulomb prefactor / epsilon
    nn_dist: float            # [Angstrom]
    high_G: float
    low_G: float
    background_temp: float
    # heat models (physics/heat.py)
    dissipation_constant: float = 0.0   # global model [J/Ks]
    t_ox: float = 0.0         # oxide thickness [m]
    A: float = 0.0            # device area [m^2]
    c_p: float = 0.0          # [J/K cm^3]
    delta_t: float = 0.0      # local model substep [s]
    tau: float = 0.0          # thermal rate constant [1/s]
    k_th_interface: float = 0.0
    k_th_vacancies: float = 0.0
    m_e: float = 0.0          # effective electron mass [kg]
    V0: float = 0.0           # defect state energy [eV]
    num_source_inj: int = 0
    num_ground_ext: int = 0
    num_atoms_contact: int = 0
    num_layers_contact: int = 0
    solve_potential: bool = True
    solve_current: bool = False
    solve_heating_global: bool = False
    solve_heating_local: bool = False
    perturb_structure: bool = True
    solver_tol: float = 1e-12
    transport_tol: float = 1e-8
    solver_maxiter: int = 50000
    selection: str = "two_level"
    event_mode: str = "incremental"
    max_events_per_superstep: int = 10000
    poisson_compact_cap: int = 0
    poisson_kernel: str = "jnp"
    active_rows_cap: int = 0
    boundary_precond: str = "jacobi"
    boundary_incremental: bool = True
    boundary_delta_cap: int = 256
    coarse_slabs: int = 16
    coarse_yz: int = 1
    # blocked transport (physics/current.py)
    transport: str = "dense"
    transport_precond: str = "jacobi"       # cold solves
    transport_warm_precond: str = "jacobi"  # in-superstep re-solves
    transport_cc: str = "stored"            # metal x metal block: "stored" | "fly"
                                            # ("auto" until the engine resolves it)
    transport_bf16_inner: bool = False      # the inner CG's band in bf16 (physics/
                                            # current.py), eager and in the captured
                                            # superstep
    transport_incremental: bool = False     # resolved by the engine from the config's
                                            # "auto" | "on" | "off"
    transport_delta_cap: int = 16
    transport_skip_unchanged: bool = True
    tunnel_vac_cap: int = 0                 # vacancy bucket of the tunnel blocks
    tunnel_int_steps: int = 1024            # energy-window steps; exact while
                                            # >= ceil(max |dE_CB| / (q * 0.01 V))
    mixed: bool = False
    dtype: torch.dtype = torch.float64


@dataclass
class SimState:
    element: torch.Tensor             # [N] int32
    charge: torch.Tensor              # [N] int32
    potential_boundary: torch.Tensor  # [N] float [V]
    potential_charge: torch.Tensor    # [N] float [V]
    CB_edge: torch.Tensor             # [N] float [J], solved at every bias start
    power: torch.Tensor               # [N] float [W]: dissipated power of the last
                                      # transport solve (0 with heating off)
    temperature: torch.Tensor         # [N] float [K]
    virtual_potentials: torch.Tensor  # [N_atom+2] float: transport warm start
    cvac_prev: torch.Tensor           # [N] bool: neutral-vacancy mask at last boundary solve
    boundary_r: torch.Tensor          # [N] float: TRUE residual b - L x of potential_boundary
    boundary_b: torch.Tensor          # [N] float: its right-hand side
    key: Tuple[int, int]              # threefry raw key
    T_bg: float                       # [K]
    kmc_time: float                   # [s] within the current bias point
    I_macro: float                    # [A]
    P_tot: float                      # [W]: sum of ``power``
    Vd_prev: float                    # bias at the last boundary solve (nan: none)
    # change tracking of the transport solve: X depends only on (element,
    # charge) at atom sites, the bias-start CB edge and Vd
    trans_elem_prev: torch.Tensor     # [N_atom] int32: element[atom_ind] at last solve
    trans_charge_prev: torch.Tensor   # [N_atom] int32
    transport_Vd_prev: float          # bias at the last transport solve (nan: none)
    # persistent vacancy tunnel blocks (params.transport_incremental; sized by
    # attach_tunnel_state, 0-shaped otherwise): row i is the block row of the
    # atom in ascending-bucket slot i at the last solve
    tt_slot_atom: torch.Tensor        # [vcap] int32: atom in the slot, -1 empty
    tt_vm: torch.Tensor               # [vcap, n_mp]: window-integral block
    tt_vv: torch.Tensor               # [vcap, vcap]: single-shot block
    tt_valid: bool


def _dtype_of(precision: str) -> torch.dtype:
    return torch.float32 if precision == "f32" else torch.float64


def _as_dtype(x: float, dtype: torch.dtype) -> float:
    """A Python float holding ``x`` rounded to ``dtype``."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


# ----------------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------------

def _site_dist(pos_i: torch.Tensor, pos_j: torch.Tensor, lattice, pbc: bool):
    """structure.site_dist in torch, same f64 arithmetic (half-even round,
    components summed x, y, z in order)."""
    d = pos_i - pos_j
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    if pbc:
        fy = dy / lattice[1]
        dy = (fy - torch.round(fy)) * lattice[1]
        fz = dz / lattice[2]
        dz = (fz - torch.round(fz)) * lattice[2]
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


def _reverse_slots(neigh_idx: torch.Tensor) -> torch.Tensor:
    """rev_slot[i,s] = t with neigh_idx[j,t] == i for j = neigh_idx[i,s].
    Rows are ascending, so t = #(entries of row j below i)."""
    n, m = neigh_idx.shape
    rev_slot = torch.full((n, m), -1, dtype=torch.int32, device=neigh_idx.device)
    chunk = max(1, (1 << 24) // max(m * m, 1))
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        nb_c = neigh_idx[c0:c1].long()
        jrows = neigh_idx[nb_c.clamp(min=0)]                     # [C, m, m]
        i_col = torch.arange(c0, c1, device=neigh_idx.device)[:, None, None]
        rev = ((jrows >= 0) & (jrows < i_col)).sum(dim=-1, dtype=torch.int32)
        rev_slot[c0:c1] = torch.where(nb_c >= 0, rev, -1).to(torch.int32)
    return rev_slot


def build_geometry(
    elements: np.ndarray,
    coords: np.ndarray,
    cfg: KMCConfig,
    neigh_idx=None,
    device="cuda",
    pad_to: int = 1,
) -> Geometry:
    """Build the static geometry on ``device``.  ``neigh_idx`` (numpy or
    tensor, file order) is built on the device when not given.  ``pad_to``
    rounds the site axis up to a multiple with inert DEFECT pad sites that
    have no neighbours (at the first site's position, after every real
    site), so that it splits evenly over the ranks of a mesh."""
    dev = resolve_device(device)
    dtype = _dtype_of(cfg.precision)
    lattice = np.asarray(cfg.lattice, dtype=np.float64)
    elements = np.asarray(elements)
    coords = np.asarray(coords, dtype=np.float64)
    if neigh_idx is None:
        neigh_idx = build_neighbor_list(coords, lattice, cfg.nn_dist, cfg.pbc, dev)
    nb = torch.as_tensor(np.asarray(neigh_idx) if not torch.is_tensor(neigh_idx)
                         else neigh_idx).to(device=dev, dtype=torch.int32)

    n = len(elements)
    if getattr(cfg, "site_order", "file") == "x":
        order = np.argsort(coords[:, 0], kind="stable").astype(np.int32)
    else:
        order = np.arange(n, dtype=np.int32)
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(n, dtype=np.int32)
    if not np.array_equal(order, np.arange(n)):
        elements = elements[order]
        coords = coords[order]
        order_t = torch.as_tensor(order, device=dev).long()
        inv_t = torch.as_tensor(inv_order, device=dev)
        nb = nb[order_t]
        nb = torch.where(nb >= 0, inv_t[nb.clamp(min=0).long()], -1)
        # keep rows ascending (rev_slot relies on it)
        big = torch.iinfo(torch.int32).max
        nb = torch.sort(torch.where(nb < 0, big, nb), dim=1).values
        nb = torch.where(nb == big, -1, nb).to(torch.int32)

    n_real = n
    n_pad = (-n_real) % max(pad_to, 1)
    if n_pad:
        elements = np.concatenate([elements, np.full(n_pad, int(Element.DEFECT),
                                                     dtype=elements.dtype)])
        coords = np.concatenate([coords, np.tile(coords[:1], (n_pad, 1))])
        nb = torch.cat([nb, torch.full((n_pad, nb.shape[1]), -1, dtype=torch.int32,
                                       device=dev)])
        n = n_real + n_pad
        # pad sites map to the file positions past the structure's
        order = np.concatenate([order, n_real + np.arange(n_pad, dtype=np.int32)])
        inv_order = np.concatenate([inv_order, n_real + np.arange(n_pad, dtype=np.int32)])

    m = nb.shape[1]
    valid = nb >= 0
    safe = nb.clamp(min=0).long()

    coords_t = torch.as_tensor(coords, device=dev)
    dist = _site_dist(coords_t[:, None, :], coords_t[safe], lattice, cfg.pbc)
    degenerate = valid & (dist <= 0.0)
    n_degenerate = int(degenerate.sum().item())
    if n_degenerate:
        print(
            f"# note: {n_degenerate} neighbour pairs at zero distance "
            "(duplicate coordinates in the input structure); their Coulomb "
            "kernel is zeroed",
            file=sys.stderr,
        )
    dead = ~valid | degenerate
    dist = torch.where(dead, 1.0, dist)

    # screened-Coulomb self-interaction kernel per unit charge
    # v_solve(r, q) = q * erfc(r/(sigma*sqrt2)) * k * e / r  (src/utils.h:102)
    from scipy.special import erfc as np_erfc

    r_m = dist.cpu().numpy() * 1e-10
    v2 = np_erfc(r_m / (cfg.sigma * np.sqrt(2.0))) * cfg.k * C.Q_C / r_m
    v2 = torch.where(dead, 0.0, torch.as_tensor(v2, device=dev))

    site_layer = assign_layers(coords, cfg.layers)
    layer_E = np.array(
        [[l.E_gen_0, l.E_rec_1, l.E_diff_2, l.E_diff_3] for l in cfg.layers],
        dtype=np.float64,
    )
    metal_ids = {int(Element[m_]) for m_ in cfg.metals}
    metal_table = np.array([i in metal_ids for i in range(len(Element))], dtype=bool)
    atom_mask = ~np.isin(elements, [int(e) for e in NON_ATOM_ELEMENTS])

    # the boundary solve's Dirichlet masks are positional in FILE order
    fpos = order
    bp_w = cfg.num_atoms_contact \
        if getattr(cfg, "bc_pinned_width", "first_layer") == "full_contact" \
        else cfg.num_atoms_first_layer

    def t(a, dt=None):
        return torch.as_tensor(a, device=dev, dtype=dt)

    # atom slots are ordered by FILE position: the transport solver's
    # positional rules (injection = first atoms, ground = last, the metal_p
    # extents) are defined on the file order (src/current_solver.cpp:86-99,
    # 181-191)
    a_int = np.nonzero(atom_mask)[0]
    atom_ind = a_int[np.argsort(fpos[a_int], kind="stable")].astype(np.int32)
    na = len(atom_ind)
    # interior-metal atoms (metal_p; static, no event changes a metal site)
    aidx = np.arange(na)
    nlc, nsi = cfg.num_layers_contact, cfg.num_atoms_first_layer
    metalp = (metal_table[elements[atom_ind]]
              & (aidx > (nlc - 1) * nsi) & (aidx < na - (nlc - 1) * nsi))
    atom_metalp_idx = np.nonzero(metalp)[0].astype(np.int32)
    atom_metalp_inv = np.full(na, -1, dtype=np.int32)
    atom_metalp_inv[atom_metalp_idx] = np.arange(len(atom_metalp_idx), dtype=np.int32)
    # the neighbour graph restricted to atom sites, in atom slots
    atom_ind_t = t(atom_ind).long()
    site_to_atom = torch.full((n,), -1, dtype=torch.int32, device=dev)
    site_to_atom[atom_ind_t] = torch.arange(na, dtype=torch.int32, device=dev)
    anb_sites = nb[atom_ind_t]
    atom_neigh_idx = torch.where(
        anb_sites >= 0, site_to_atom[anb_sites.clamp(min=0).long()], -1
    ).to(torch.int32)
    n_first = cfg.num_atoms_first_layer

    return Geometry(
        coords=coords_t.to(dtype),
        neigh_idx=nb,
        neigh_valid=valid,
        v2_pair=v2.to(dtype),
        site_layer=t(site_layer, torch.int32),
        metal_mask_table=t(metal_table),
        layer_E=t(layer_E, dtype),
        rev_slot=_reverse_slots(nb),
        io_idx=t(inv_order, torch.int32),
        io_fpos=t(fpos, torch.int32),
        bp_left_mask=t(fpos < bp_w),
        bp_right_mask=t((fpos >= n_real - bp_w) & (fpos < n_real)),
        bp_interior_mask=t((fpos >= bp_w) & (fpos < n_real - bp_w)),
        left_mask=t(fpos < n_first),
        right_mask=t((fpos >= n_real - n_first) & (fpos < n_real)),
        interior_mask=t((fpos >= n_first) & (fpos < n_real - n_first)),
        inner_mask=t((fpos >= cfg.num_atoms_contact)
                     & (fpos < n_real - cfg.num_atoms_contact)),
        atom_ind=t(atom_ind),
        atom_metalp_idx=t(atom_metalp_idx),
        atom_metalp_inv=t(atom_metalp_inv),
        atom_neigh_idx=atom_neigh_idx,
        N=int(n),
        max_nn=int(m),
        N_atom=int(atom_mask.sum()),
        pbc=bool(cfg.pbc),
        N_real=int(n_real),
        lattice_host=tuple(float(_as_dtype(x, dtype)) for x in lattice),
    )


def build_params(cfg: KMCConfig) -> PhysParams:
    for opt, allowed in (
        ("boundary_precond", ("jacobi", "deflated")),
        ("poisson_kernel", ("jnp", "pallas")),
        ("ell_gather_kernel", ("jnp", "pallas")),
        ("precision", ("f64", "f32", "mixed")),
        ("event_mode", ("incremental", "scan")),
        ("selection", ("two_level", "flat")),
        ("transport", ("dense", "blocked")),
        ("transport_precond", ("jacobi", "deflated")),
        ("transport_warm_precond", ("jacobi", "deflated")),
        ("transport_cc", ("auto", "stored", "fly")),
        ("transport_incremental", ("auto", "on", "off")),
        ("transport_band_kernel", ("jnp", "pallas")),
        ("tunnel_vm_kernel", ("jnp", "pallas")),
    ):
        if getattr(cfg, opt) not in allowed:
            raise ValueError(f"unknown {opt}={getattr(cfg, opt)!r}; expected one of {allowed}")
    dtype = _dtype_of(cfg.precision)
    s = lambda x: _as_dtype(x, dtype)
    return PhysParams(
        freq=s(cfg.freq),
        sigma=s(cfg.sigma),
        k=s(cfg.k),
        nn_dist=s(cfg.nn_dist),
        high_G=s(cfg.high_G),
        low_G=s(cfg.low_G),
        background_temp=s(cfg.background_temp),
        dissipation_constant=s(cfg.dissipation_constant),
        t_ox=s(cfg.t_ox),
        A=s(cfg.A),
        c_p=s(cfg.c_p),
        delta_t=s(cfg.delta_t),
        tau=s(cfg.tau),
        k_th_interface=s(cfg.k_th_interface),
        k_th_vacancies=s(cfg.k_th_vacancies),
        m_e=s(cfg.m_e),
        V0=s(cfg.V0),
        num_source_inj=cfg.num_atoms_first_layer,
        num_ground_ext=cfg.num_atoms_first_layer,
        num_atoms_contact=cfg.num_atoms_contact,
        num_layers_contact=cfg.num_layers_contact,
        solve_potential=cfg.solve_potential,
        solve_current=cfg.solve_current,
        solve_heating_global=cfg.solve_heating_global,
        solve_heating_local=cfg.solve_heating_local,
        perturb_structure=cfg.perturb_structure,
        solver_tol=cfg.solver_tol,
        transport_tol=cfg.transport_tol,
        solver_maxiter=cfg.solver_maxiter,
        selection=cfg.selection,
        event_mode=cfg.event_mode,
        max_events_per_superstep=cfg.max_events_per_superstep,
        poisson_compact_cap=cfg.poisson_compact_cap,
        poisson_kernel=cfg.poisson_kernel,
        active_rows_cap=max(cfg.active_rows_cap, 0),
        boundary_precond=cfg.boundary_precond,
        boundary_incremental=cfg.boundary_incremental,
        boundary_delta_cap=cfg.boundary_delta_cap,
        coarse_slabs=cfg.coarse_slabs,
        coarse_yz=cfg.coarse_yz,
        transport=cfg.transport,
        transport_precond=cfg.transport_precond,
        transport_warm_precond=cfg.transport_warm_precond,
        transport_cc=cfg.transport_cc,
        transport_bf16_inner=cfg.transport_bf16_inner,
        # transport_incremental stays False here: the engine resolves the
        # config's "auto" | "on" | "off" once n_mp and the final
        # tunnel_vac_cap are known, then sizes the state (attach_tunnel_state)
        transport_delta_cap=cfg.transport_delta_cap,
        transport_skip_unchanged=cfg.transport_skip_unchanged,
        tunnel_vac_cap=max(cfg.tunnel_vac_cap, 0),
        tunnel_int_steps=cfg.tunnel_int_steps,
        mixed=(cfg.precision == "mixed"),
        dtype=dtype,
    )


def make_substoichiometric(
    elements: np.ndarray, concentration: float, seed: int
) -> np.ndarray:
    """Convert ``concentration * num_O`` random oxygen atoms to vacancies via
    a rejection loop over uniform draws (src/Device.cpp:202-233)."""
    out = elements.copy()
    atom_ind = np.nonzero(
        ~np.isin(out, [int(e) for e in NON_ATOM_ELEMENTS])
    )[0]
    n_atom = len(atom_ind)
    num_o = int((out == int(Element.O)).sum())
    num_add = int(concentration * num_o)
    gen = np.random.default_rng(seed)
    while num_add > 0:
        loc = int(gen.random() * n_atom)
        site = atom_ind[loc]
        if out[site] == int(Element.O):
            out[site] = int(Element.VACANCY)
            num_add -= 1
    return out


def init_state(geom: Geometry, cfg: KMCConfig, elements: np.ndarray) -> SimState:
    dtype = _dtype_of(cfg.precision)
    dev = geom.device
    n = geom.N
    elements = np.asarray(elements)
    if len(elements) < n:
        # the pad sites of a geometry padded for a mesh (build_geometry)
        elements = np.concatenate([elements, np.full(n - len(elements), int(Element.DEFECT),
                                                     dtype=elements.dtype)])
    # FILE order -> internal site order
    elements = elements[geom.io_fpos.cpu().numpy()]
    zeros = lambda: torch.zeros(n, dtype=dtype, device=dev)
    return SimState(
        element=torch.as_tensor(elements, dtype=torch.int32, device=dev),
        charge=torch.zeros(n, dtype=torch.int32, device=dev),
        potential_boundary=zeros(),
        potential_charge=zeros(),
        CB_edge=zeros(),
        power=zeros(),
        temperature=torch.full((n,), _as_dtype(cfg.background_temp, dtype),
                               dtype=dtype, device=dev),
        virtual_potentials=torch.zeros(geom.N_atom + 2, dtype=dtype, device=dev),
        cvac_prev=torch.ones(n, dtype=torch.bool, device=dev),  # forces the 1st solve
        boundary_r=zeros(),
        boundary_b=zeros(),
        key=rng.prng_key(cfg.rnd_seed_kmc),
        T_bg=_as_dtype(cfg.background_temp, dtype),
        kmc_time=0.0,
        I_macro=0.0,
        P_tot=0.0,
        Vd_prev=float("nan"),
        trans_elem_prev=torch.full((geom.N_atom,), -1, dtype=torch.int32, device=dev),
        trans_charge_prev=torch.zeros(geom.N_atom, dtype=torch.int32, device=dev),
        transport_Vd_prev=float("nan"),
        tt_slot_atom=torch.zeros(0, dtype=torch.int32, device=dev),
        tt_vm=torch.zeros((0, 0), dtype=torch.float32, device=dev),
        tt_vv=torch.zeros((0, 0), dtype=torch.float32, device=dev),
        tt_valid=False,
    )


def attach_tunnel_state(state: SimState, geom: Geometry, params: PhysParams) -> SimState:
    """Size (or clear) the persistent tunnel-block fields for
    ``params.transport_incremental``.  Call after every change to
    ``tunnel_vac_cap`` or ``tunnel_int_steps``.  Always returns an INVALID
    store (``tt_valid=False``): the next solve rebuilds every occupied row,
    which is exactly the from-scratch assembly."""
    dev = geom.device
    if not params.transport_incremental:
        return replace(
            state,
            tt_slot_atom=torch.zeros(0, dtype=torch.int32, device=dev),
            tt_vm=torch.zeros((0, 0), dtype=torch.float32, device=dev),
            tt_vv=torch.zeros((0, 0), dtype=torch.float32, device=dev),
            tt_valid=False,
        )
    cdtype = torch.float32 if params.mixed else params.dtype
    vcap = params.tunnel_vac_cap
    n_mp = int(geom.atom_metalp_idx.shape[0])
    return replace(
        state,
        tt_slot_atom=torch.full((vcap,), -1, dtype=torch.int32, device=dev),
        tt_vm=torch.zeros((vcap, n_mp), dtype=cdtype, device=dev),
        tt_vv=torch.zeros((vcap, vcap), dtype=cdtype, device=dev),
        tt_valid=False,
    )


def build_simulation(
    cfg: KMCConfig,
    elements: Optional[np.ndarray] = None,
    coords: Optional[np.ndarray] = None,
    neigh_idx=None,
    device="cuda",
    pad_to: int = 1,
) -> Tuple[Geometry, PhysParams, SimState]:
    """Full setup: read structure files (or accept arrays), apply shifts and
    substoichiometry, build geometry/params/state (reference:
    src/kmc_main.cpp:60-124, src/Device.cpp:17-96).  ``pad_to``: see
    :func:`build_geometry`."""
    import os

    from .structure import read_xyz, translate_cell

    if elements is None:
        if cfg.restart:
            if not os.path.exists(cfg.restart_xyz_file):
                raise FileNotFoundError(
                    f"ERROR: Restart file {cfg.restart_xyz_file} not found!"
                )
            elements, coords = read_xyz(cfg.restart_xyz_file)
        else:
            e1, c1 = read_xyz(cfg.atom_xyz_file)
            e2, c2 = read_xyz(cfg.interstitial_xyz_file)
            elements = np.concatenate([e1, e2])
            coords = np.concatenate([c1, c2])
    elements = np.asarray(elements, dtype=np.int32)
    coords = np.asarray(coords, dtype=np.float64)
    if cfg.shift:
        coords = translate_cell(coords, cfg.lattice, cfg.shifts)
    if cfg.pristine and not cfg.restart:
        elements = make_substoichiometric(
            elements, cfg.initial_vacancy_concentration, cfg.rnd_seed
        )
    geom = build_geometry(elements, coords, cfg, neigh_idx=neigh_idx,
                          device=device, pad_to=pad_to)
    params = build_params(cfg)
    state = init_state(geom, cfg, elements)
    return geom, params, state


# ----------------------------------------------------------------------------
# carrying the JAX package's arrays across
# ----------------------------------------------------------------------------

_INT_FIELDS = {"neigh_idx", "site_layer", "rev_slot", "io_idx", "io_fpos",
               "element", "charge", "atom_ind", "atom_metalp_idx",
               "atom_metalp_inv", "atom_neigh_idx", "trans_elem_prev",
               "trans_charge_prev", "tt_slot_atom"}
_STATIC_GEOM = {"N", "max_nn", "N_atom", "pbc", "N_real"}
_HOST_STATE = {"T_bg", "kmc_time", "I_macro", "P_tot", "Vd_prev",
               "transport_Vd_prev"}


def _tensor(name: str, a, dev) -> torch.Tensor:
    a = np.array(a)     # a writable copy
    if name in _INT_FIELDS:
        a = a.astype(np.int32)
    return torch.as_tensor(a, device=dev)


def _state_from_arrays(state: dict, dev) -> SimState:
    """A single state from {field: numpy array}, host scalars read."""
    skw = {}
    for f in dataclasses.fields(SimState):
        v = state[f.name]
        if f.name == "key":
            skw[f.name] = rng.key_from_array(v)
        elif f.name in _HOST_STATE:
            skw[f.name] = float(np.asarray(v))
        elif f.name == "tt_valid":
            skw[f.name] = bool(np.asarray(v))
        else:
            skw[f.name] = _tensor(f.name, v, dev)
    return SimState(**skw)


def from_jax_arrays(geom: dict, state: dict, device="cuda"):
    """Turn the JAX package's Geometry and SimState, given as dicts of numpy
    arrays (and the static ints), into the port's records on ``device``,
    heat state (``temperature``, ``power``, ``P_tot``, ``T_bg``) included.
    Fields the port does not carry are ignored.  Returns
    ``(Geometry, SimState)``; a JAX ``HeatModel`` goes through
    ``physics.heat.heat_from_jax_arrays``."""
    if int(geom["N_real"]) != int(geom["N"]):
        raise ValueError("from_jax_arrays: padded geometries are not supported")
    dev = resolve_device(device)
    gkw = {}
    for f in dataclasses.fields(Geometry):
        if f.name == "lattice_host":
            continue
        if f.name in _STATIC_GEOM:
            gkw[f.name] = type(f.default)(geom[f.name])
        else:
            gkw[f.name] = _tensor(f.name, geom[f.name], dev)
    gkw["lattice_host"] = tuple(float(x) for x in np.asarray(geom["lattice"]))
    g = Geometry(**gkw)

    return g, _state_from_arrays(state, dev)


def batched_state_from_numpy(state: dict, device="cuda") -> SimState:
    """A JAX batched ``SimState`` (``parallel.batched.batch_states`` or a
    batched superstep's output), given as {field: numpy array} with the
    leading replica axis, as the port's batched state on ``device``."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(SimState):
        v = np.asarray(state[f.name])
        if f.name == "key":
            kw[f.name] = torch.as_tensor(v.astype(np.uint32).reshape(-1, 2), device=dev)
        elif f.name in _HOST_STATE:
            kw[f.name] = torch.as_tensor(v.astype(np.float64), device=dev)
        elif f.name == "tt_valid":
            kw[f.name] = torch.as_tensor(v.astype(bool), device=dev)
        else:
            kw[f.name] = _tensor(f.name, v, dev)
    return SimState(**kw)


# ----------------------------------------------------------------------------
# batched states: B replicas of one geometry
# ----------------------------------------------------------------------------

def batch_size(states: SimState) -> int:
    return int(states.element.shape[0])


def stack_states(states: Sequence[SimState]) -> SimState:
    """B single states as one batched state (new tensors)."""
    dev = states[0].element.device
    kw = {}
    for f in dataclasses.fields(SimState):
        vals = [getattr(s, f.name) for s in states]
        if f.name == "key":
            kw[f.name] = rng.keys_tensor(vals, dev)
        elif f.name in _HOST_STATE:
            kw[f.name] = torch.tensor(vals, dtype=torch.float64, device=dev)
        elif f.name == "tt_valid":
            kw[f.name] = torch.tensor(vals, dtype=torch.bool, device=dev)
        else:
            kw[f.name] = torch.stack(vals)
    return SimState(**kw)


_HOST_NAMES = sorted(_HOST_STATE)
#: columns of host_block: the host scalars, the key's two words, tt_valid
HOST_COLS = len(_HOST_NAMES) + 3


def host_block(states: SimState) -> torch.Tensor:
    """[B, HOST_COLS] f64 on the device: each replica's host scalars (in sorted
    order), the two words of its key and tt_valid (:func:`host_values` reads
    a row back)."""
    return torch.cat([torch.stack([getattr(states, n).to(torch.float64) for n in _HOST_NAMES],
                                  dim=1),
                      states.key.to(torch.float64),
                      states.tt_valid.to(torch.float64)[:, None]], dim=1)


def host_values(row: Sequence[float]) -> dict:
    """A single state's host fields from its row of :func:`host_block`."""
    return dict(zip(_HOST_NAMES, (float(v) for v in row)),
                key=(int(row[-3]), int(row[-2])), tt_valid=bool(row[-1]))


def host_row(state: SimState) -> List[float]:
    """A single state's row of :func:`host_block`, from its host fields."""
    return ([float(getattr(state, n)) for n in _HOST_NAMES]
            + [float(w) for w in state.key] + [float(state.tt_valid)])


def set_host(states: SimState, block: torch.Tensor) -> None:
    """Write each replica's host scalars, key and tt_valid from its row of
    ``block`` (:func:`host_block`'s layout), on the device."""
    for j, n in enumerate(_HOST_NAMES):
        getattr(states, n).copy_(block[:, j])
    words = block[:, -3:-1].to(torch.int64)
    states.key.view(torch.int32).copy_(torch.where(words >= 2**31, words - 2**32, words))
    states.tt_valid.copy_(block[:, -1] != 0)


def _host_rows(states: SimState) -> List[dict]:
    """The host scalars, key and tt_valid of every replica, read in one
    transfer."""
    return [host_values(row) for row in host_block(states).tolist()]


def _unbatch(states: SimState, b: int, host: dict) -> SimState:
    kw = {f.name: host[f.name] if f.name in host else getattr(states, f.name)[b]
          for f in dataclasses.fields(SimState)}
    return SimState(**kw)


def unbatch(states: SimState, b: int) -> SimState:
    """Replica ``b`` of a batched state as a single state (views of its
    tensors; its scalars and key read to the host)."""
    return _unbatch(states, b, _host_rows(states)[b])


def unbatch_all(states: SimState) -> List[SimState]:
    """Every replica of a batched state as a single state, the scalars of all
    read in one transfer."""
    return [_unbatch(states, b, host) for b, host in enumerate(_host_rows(states))]
