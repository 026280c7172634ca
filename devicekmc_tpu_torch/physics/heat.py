"""Heat solvers: lumped global temperature and site-resolved local heat.

Global model (reference: Device::updateTemperatureGlobal,
src/heat_solver.cpp:316-350): analytic solution of the capacitative heat ODE
over the event time.  NOTE the reference evaluates the source coefficient
with the *current* background temperature rather than the ambient one
(heat_solver.cpp:332), so T_bg never falls under power; reproduced.  Pass
``ambient_coupling=True`` for the physically cooling variant.

Local model (reference: Device::updateLocalTemperature{,SteadyState},
src/heat_solver.cpp:354-513): mat-vec with a precomputed inverse of the
interface graph Laplacian.  The transient propagator (I - dt*tau*L)^-1 and
the steady-state L^-1 are computed once at set-up on the host in f64
(reference: constructLaplacian, src/heat_solver.cpp:40-246) and applied once
a substep.  The matrix-free variant (``method="cg"``) applies the Laplacian
on the ELL graph and solves every substep with CG.  Both run as the device
loops of ``ops.heat`` (the JAX package's ``lax.while_loop`` over the
substeps and ``lax.cond`` between the branches): the branch and the substep
count are computed on the device from the step time, and a state whose
scalars are 0-d device tensors (a captured superstep's) keeps T_bg there
too; a host state gets it back with one read.

Quirk reproduced: the reference's ``p_transfer_vacancies`` is built from
``k_th_interface`` and ``p_transfer_non_vacancies`` from ``k_th_vacancies``
(names swapped against the constants, heat_solver.cpp:371-372).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops import cg as cg_mod
from ..ops import heat as heat_ops
from ..state import Geometry, PhysParams, SimState, replace
from ..structure import Element
from .current import require_ieee_f32

#: what the last local-model update did: the branch taken ("transient" |
#: "steady"), its substeps and, for the matrix-free model, the CG iterations
#: summed over them (read from the device loops' counters after the run:
#: by the update itself on a host state, by ``superstep.SuperstepGraph``
#: with a replay's result)
last_local: Dict = {}


def note_local(steady, substeps, cg_iters) -> None:
    """Set :data:`last_local` from the device loops' log (``ops.heat``
    ``Workspace.log``, read)."""
    last_local.clear()
    last_local.update(branch="steady" if steady else "transient", substeps=int(substeps),
                      cg_iters=int(cg_iters))


@dataclass
class HeatModel:
    """Precomputed local-heat operators (empty if local heating is off).

    Two application methods:
      * ``dense``: the reference's approach, dense inverses and one product
        per substep (O(Ni^2) memory, fine to ~10k interface sites);
      * ``cg``: matrix-free, the Laplacian applied on the ELL graph and each
        substep solving (I - dt*tau*L) T' = rhs with CG (a small
        perturbation of the identity, so a handful of iterations).
    """

    L_inv: torch.Tensor           # [Ni, Ni] transient propagator (dense)
    L_ss_inv: torch.Tensor        # [Ni, Ni] steady-state L^-1 (dense)
    interface_idx: torch.Tensor   # [Ni] int64 site indices of the interface sites
    interface_mask: torch.Tensor  # [N] bool (cg)
    diag_base: torch.Tensor       # [N] float: -gamma where metal-adjacent, else 0 (cg)
    step_scale: float             # dt * tau
    n_interface: int = 0
    n_left: int = 0
    n_right: int = 0
    method: str = "dense"
    # static parts of the matrix-free Laplacian (cg), made at set-up
    nb_int: Optional[torch.Tensor] = None     # [N, max_nn] bool: interface neighbours
    n_int_nb: Optional[torch.Tensor] = None   # [N] float: their count
    # the device loops' buffers and operator forms (ops.heat.Workspace), made
    # with the model, before any capture
    ws: Optional[heat_ops.Workspace] = None


def _npd(params: PhysParams):
    return np.float32 if params.dtype == torch.float32 else np.float64


def _num_in_contact_left(elements: np.ndarray, m: int) -> int:
    """Span from the start containing m non-DEFECT sites
    (src/heat_solver.cpp:5-20)."""
    count = seen = 0
    while seen < m:
        if elements[count] != int(Element.DEFECT):
            seen += 1
        count += 1
    return count


def _num_in_contact_right(elements: np.ndarray, m: int) -> int:
    """Span from the end containing m non-DEFECT sites
    (src/heat_solver.cpp:21-34)."""
    n = len(elements)
    count = n
    seen = 0
    while seen < m:
        count -= 1
        if elements[count] != int(Element.DEFECT):
            seen += 1
    return n - count


def _cg_static(geom: Geometry, mask: torch.Tensor):
    """Interface-neighbour mask and count of the matrix-free Laplacian."""
    safe = geom.neigh_idx.clamp(min=0).long()
    nb_int = mask[safe] & geom.neigh_valid
    return nb_int, nb_int.sum(dim=1).to(geom.coords.dtype)


def _with_device_form(model: HeatModel, geom: Geometry) -> HeatModel:
    """``model`` with the device loops' workspace (``ops.heat.workspace``):
    for the matrix-free model the ELL forms of its two operators over the
    geometry's neighbour list."""
    if model.n_interface:
        model.ws = heat_ops.workspace(
            model.method, model.diag_base.dtype, geom.device, model.interface_idx,
            neigh_idx=geom.neigh_idx, mask=model.interface_mask, diag_base=model.diag_base,
            nb_int=model.nb_int, n_int_nb=model.n_int_nb, step_scale=model.step_scale)
    return model


def build_heat_model(
    geom: Geometry,
    params: PhysParams,
    cfg,
    elements: np.ndarray,
    neigh_idx: np.ndarray,
    method: str = "dense",
    contact_spans=None,
) -> HeatModel:
    """Host-side precompute of the interface Laplacian inverses (reference:
    constructLaplacian, src/heat_solver.cpp:40-246); with ``method="cg"``
    only the graph metadata is prepared (no dense work).  ``elements`` and
    ``neigh_idx`` are numpy arrays in the internal site order; the model's
    tensors live on the geometry's device.

    ``contact_spans``: optional (n_left, n_right) site-span override.  The
    reference's span rule counts ``n_metals - num_atoms_contact`` metals from
    the right (src/heat_solver.cpp:21-34): right for its single devices,
    where every metal belongs to a contact, but wrong for crossbars with
    interior metal (word and bit lines), where it swallows the whole device
    into the "right contact".  Crossbar-scale callers pass symmetric spans."""
    if method not in ("dense", "cg"):
        raise ValueError(f"unknown heat_solver={method!r}; expected 'dense' or 'cg'")
    dev = geom.device
    dtype = params.dtype
    elements = np.asarray(elements)
    neigh_idx = np.asarray(neigh_idx)
    n = len(elements)
    metal_table = geom.metal_mask_table.cpu().numpy()
    if contact_spans is not None:
        n_left, n_right = contact_spans
    else:
        n_metals = int(metal_table[elements].sum())
        n_left = _num_in_contact_left(elements, cfg.num_atoms_contact)
        n_right = _num_in_contact_right(elements, n_metals - cfg.num_atoms_contact)
    ni = n - n_left - n_right

    index_map = np.full(n, -1, dtype=np.int64)
    interface_idx = np.arange(n_left, n - n_right)
    index_map[interface_idx] = np.arange(ni)

    gamma = 1.0 / (cfg.delta * ((cfg.k_th_interface / cfg.k_th_metal) + 1.0))
    step_time = cfg.delta_t * cfg.tau
    step_scale = float(_npd(params)(step_time))
    iidx_t = torch.as_tensor(interface_idx, dtype=torch.int64, device=dev)

    if method == "cg":
        interface_mask = np.zeros(n, dtype=bool)
        interface_mask[interface_idx] = True
        # site i is bath-coupled iff any neighbour is a metal element
        nb_ok = neigh_idx >= 0
        metal_nb = (metal_table[elements[np.where(nb_ok, neigh_idx, 0)]] & nb_ok).any(axis=1)
        diag_base = np.where(metal_nb & interface_mask, -gamma, 0.0)
        z = torch.zeros((0, 0), dtype=dtype, device=dev)
        mask_t = torch.as_tensor(interface_mask, device=dev)
        nb_int, n_int_nb = _cg_static(geom, mask_t)
        return _with_device_form(HeatModel(
            L_inv=z, L_ss_inv=z, interface_idx=iidx_t, interface_mask=mask_t,
            diag_base=torch.as_tensor(diag_base, device=dev).to(dtype),
            step_scale=step_scale,
            n_interface=int(ni), n_left=int(n_left), n_right=int(n_right),
            method="cg", nb_int=nb_int, n_int_nb=n_int_nb,
        ), geom)

    require_ieee_f32("the local heat model's propagator products")
    L = np.zeros((ni, ni), dtype=np.float64)
    for i in interface_idx:
        ii = index_map[i]
        for j in neigh_idx[i]:
            if j < 0:
                continue
            jj = index_map[j]
            if jj >= 0 and j != i:
                L[ii, jj] = 1.0
            if metal_table[elements[j]]:
                # boundary site, coupled to the metal bath: SET, once,
                # however many metal neighbours the site has
                L[ii, ii] = -gamma
    # diagonal: L_ii += -sum_{j != i} L_ij  (on top of any -gamma)
    off_sums = L.sum(axis=1) - np.diagonal(L)
    L[np.arange(ni), np.arange(ni)] += -off_sums

    L_inv = np.linalg.inv(np.eye(ni) - step_time * L)
    L_ss_inv = np.linalg.inv(L)
    return _with_device_form(HeatModel(
        L_inv=torch.as_tensor(L_inv, device=dev).to(dtype).contiguous(),
        L_ss_inv=torch.as_tensor(L_ss_inv, device=dev).to(dtype).contiguous(),
        interface_idx=iidx_t,
        interface_mask=torch.zeros(n, dtype=torch.bool, device=dev),
        diag_base=torch.zeros(n, dtype=dtype, device=dev),
        step_scale=step_scale,
        n_interface=int(ni), n_left=int(n_left), n_right=int(n_right),
        method="dense",
    ), geom)


def empty_heat_model(params: PhysParams, device="cpu") -> HeatModel:
    z = torch.zeros((0, 0), dtype=params.dtype, device=device)
    return HeatModel(
        L_inv=z, L_ss_inv=z,
        interface_idx=torch.zeros(0, dtype=torch.int64, device=device),
        interface_mask=torch.zeros(0, dtype=torch.bool, device=device),
        diag_base=torch.zeros(0, dtype=params.dtype, device=device),
        step_scale=0.0,
    )


def heat_from_jax_arrays(heat: dict, geom: Geometry) -> HeatModel:
    """Turn the JAX package's HeatModel, given as a dict of numpy arrays and
    its static fields, into the port's on the geometry's device."""
    dev = geom.device
    t = lambda k: torch.as_tensor(np.array(heat[k]), device=dev)
    model = HeatModel(
        L_inv=t("L_inv"), L_ss_inv=t("L_ss_inv"),
        interface_idx=t("interface_idx").long(),
        interface_mask=t("interface_mask"), diag_base=t("diag_base"),
        step_scale=float(np.asarray(heat["step_scale"])),
        n_interface=int(heat["n_interface"]), n_left=int(heat["n_left"]),
        n_right=int(heat["n_right"]), method=str(heat["method"]),
    )
    if model.method == "cg" and model.n_interface:
        model.nb_int, model.n_int_nb = _cg_static(geom, model.interface_mask)
    model.L_inv, model.L_ss_inv = model.L_inv.contiguous(), model.L_ss_inv.contiguous()
    return _with_device_form(model, geom)


# ----------------------------------------------------------------------------
# global (lumped) model
# ----------------------------------------------------------------------------

def global_ode(
    params: PhysParams, T_bg, P_tot, step_time, ambient_coupling: bool = False,
):
    """Analytic solution of the capacitative heat ODE over the event time
    (src/heat_solver.cpp:316-350), evaluated in the working dtype: T_bg,
    P_tot and step_time 0-d tensors (the result one, on their device: a
    captured superstep's work, no read) or host numbers (the result a float).
    The constants that depend on ``params`` alone are made on the host."""
    f = _npd(params)
    if not torch.is_tensor(T_bg):
        t = lambda v: torch.tensor(v, dtype=params.dtype)
        return float(global_ode(params, t(T_bg), t(P_tot), t(step_time), ambient_coupling))
    C_th = f(params.A) * f(params.t_ox) * f(params.c_p) * f(1e6)          # [J/K]
    a = f(params.dissipation_constant) / C_th
    T_couple = float(f(params.background_temp)) if ambient_coupling else T_bg
    c = float(a) * T_couple + P_tot / float(C_th)
    ca = c / float(a)
    return ca + (T_bg - ca) * torch.exp(float(-a) * step_time)


def update_temperature_global(
    params: PhysParams, state: SimState, step_time,
    ambient_coupling: bool = False,
) -> Tuple[SimState, Dict]:
    """Global (lumped) temperature update (src/heat_solver.cpp:316-350) on the
    device: P_tot is the sum of the site power, T_bg the ODE's solution
    (:func:`global_ode`).  A state whose scalars are host numbers gets
    them back as host numbers (one read); a state whose scalars are 0-d
    tensors (a captured superstep's) keeps them on the device, and so do the
    metrics."""
    dt = params.dtype
    dev = state.power.device
    P_tot = state.power.sum()
    T_bg = torch.as_tensor(state.T_bg, dtype=torch.float64, device=dev).to(dt)
    st = torch.as_tensor(step_time, dtype=torch.float64, device=dev).to(dt)
    T_new = global_ode(params, T_bg, P_tot, st, ambient_coupling)
    if not torch.is_tensor(state.T_bg):
        T_new, P_tot = torch.stack([T_new, P_tot]).to(torch.float64).tolist()
    return replace(state, T_bg=T_new, P_tot=P_tot), {
        "Global temperature [K]": T_new,
        "Total dissipated power [mW]": P_tot * 1e3,
    }


# ----------------------------------------------------------------------------
# local (site-resolved) model
# ----------------------------------------------------------------------------

def _p_transfer(params: PhysParams, elem: torch.Tensor) -> torch.Tensor:
    """Per-site power-transfer coefficient (names follow the reference's
    swapped convention, src/heat_solver.cpp:371-372)."""
    f = _npd(params)
    denom_scale = (f(params.nn_dist) * f(1e-10)) * (f(C.T_1) - f(params.background_temp))
    p_vac = float(f(1.0) / (f(params.k_th_interface) * denom_scale))
    p_non = float(f(1.0) / (f(params.k_th_vacancies) * denom_scale))
    one = torch.ones((), dtype=params.dtype, device=elem.device)
    return torch.where(elem == int(Element.VACANCY), p_vac * one, p_non * one)


def n_substeps(params: PhysParams, step_time: float) -> int:
    """floor(step_time / delta_t) + 1, the division in the working dtype."""
    f = _npd(params)
    return int(np.floor(f(step_time) / f(params.delta_t))) + 1


def is_steady(params: PhysParams, step_time: float) -> bool:
    """The steady-state branch: step_time > 1e3 delta_t, in the working
    dtype."""
    f = _npd(params)
    return bool(f(step_time) > f(1e3) * f(params.delta_t))


def branch(params: PhysParams, step_time, device):
    """``(steady, n_sub)`` of :func:`is_steady` and :func:`n_substeps`: for a
    0-d tensor ``step_time`` (a captured superstep's) computed on the device
    in the working dtype as those compute them (a 0-d bool and a 0-d int32,
    ``n_sub`` bounded so that a step time far in the steady branch does not
    overflow it), for a host number on the host."""
    if not torch.is_tensor(step_time):
        return is_steady(params, step_time), n_substeps(params, step_time)
    f = _npd(params)
    st = step_time.to(device=device, dtype=torch.float64).to(params.dtype)
    steady = st > float(f(1e3) * f(params.delta_t))
    n_sub = torch.clamp(torch.floor(st / float(f(params.delta_t))) + 1, max=2 ** 30)
    return steady, n_sub.to(torch.int32)


def _pick(steady, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` on the steady branch, else ``b``: a selection on the device when
    ``steady`` is a tensor."""
    if torch.is_tensor(steady):
        return torch.where(steady, a, b)
    return a if steady else b


def _device_ws(heat: HeatModel) -> heat_ops.Workspace:
    if heat.ws is None:
        raise ValueError("the local heat model has no device form: build it with "
                         "build_heat_model or heat_from_jax_arrays")
    return heat.ws


def update_temperature_local(
    geom: Geometry,
    params: PhysParams,
    heat: HeatModel,
    state: SimState,
    step_time,
) -> Tuple[SimState, Dict]:
    """Transient or steady-state local temperature update with the dense
    propagators (src/heat_solver.cpp:286-307 dispatch): the device loops of
    ``ops.heat.run_dense``, the transient one over the substeps of L_inv
    and the steady pass of L_ss_inv, the branch and the substep count from
    ``step_time`` (a host number or a 0-d tensor)."""
    require_ieee_f32("the local heat model's propagator products")
    f = _npd(params)
    T0 = float(f(params.background_temp))
    scale = float(f(C.T_1) - f(T0))
    ws = _device_ws(heat)
    iidx = heat.interface_idx
    P_i = state.power[iidx]
    p_t = _p_transfer(params, state.element[iidx])
    steady, n_sub = branch(params, step_time, geom.device)
    temp = state.temperature.to(params.dtype).clone()
    src = P_i * p_t * float(f(params.delta_t) * f(params.tau))
    transient = (temp[iidx] - T0) / scale + src
    ws.u[0].copy_(_pick(steady, P_i * p_t, transient))
    ws.src.copy_(src)
    heat_ops.prepare(ws, steady, n_sub)
    heat_ops.run_dense(ws, heat.L_inv, heat.L_ss_inv, temp, T0, scale)
    return finish_local_temperature(geom, params, state, temp, ws)


def _laplacian_apply(geom: Geometry, heat: HeatModel, x: torch.Tensor) -> torch.Tensor:
    """Matrix-free L @ x on interface sites (adjacency 1 + gamma boundary +
    negative-degree diagonal), full-length vectors, from the model's static
    tables: the operator whose ELL forms the device loops solve
    (``ops.heat.workspace``)."""
    mask = heat.interface_mask
    safe = geom.neigh_idx.clamp(min=0).long()
    xm = torch.where(mask, x, 0.0)
    off = torch.where(heat.nb_int, xm[safe], 0.0).sum(dim=1)
    diag = heat.diag_base - heat.n_int_nb.to(x.dtype)
    return torch.where(mask, diag * x + off, 0.0)


def _local_cg_sources(params, heat, state):
    """The shared constants of the matrix-free model and its two sources:
    ``P p_t s`` of the transient substeps and ``-P p_t`` of the steady solve,
    on the interface."""
    f = _npd(params)
    T0 = float(f(params.background_temp))
    scale = float(f(C.T_1) - f(T0))
    mask = heat.interface_mask
    p_t_full = torch.where(mask, _p_transfer(params, state.element), 0.0)
    P_full = torch.where(mask, state.power, 0.0)
    return T0, scale, P_full * p_t_full * heat.step_scale, -P_full * p_t_full


def _run_local_cg(params, heat, state, temp, steady, n_sub, tol, maxiter):
    """The matrix-free model's loops (``ops.heat.run_cg``) on ``temp`` in
    place."""
    ws = _device_ws(heat)
    T0, scale, src_t, src_s = _local_cg_sources(params, heat, state)
    ws.src.copy_(_pick(steady, src_s, src_t))
    heat_ops.prepare(ws, steady, n_sub)
    heat_ops.run_cg(ws, temp, T0, scale, tol, maxiter)
    return ws


def _cg_iterations(ws) -> int:
    """The CG iterations of the last run (a read)."""
    cg_mod.readbacks += 1
    return int(ws.log[2])


def local_cg_transient_window(
    geom: Geometry,
    params: PhysParams,
    heat: HeatModel,
    state: SimState,
    temp: torch.Tensor,
    n_sub: int,
    tol: float = 1e-10,
    maxiter: int = 1000,
) -> torch.Tensor:
    """Run ``n_sub`` transient substeps of the matrix-free local model on the
    temperature field ``temp`` and return it (the chunked modular driver's
    segment, the device loops' substeps; adds their CG iterations to
    :data:`last_local`).  Each substep is one CG solve warm-started from the
    current field; whether it met ``tol`` is not checked (the JAX package
    does not check it either)."""
    temp = temp.to(params.dtype).clone()
    ws = _run_local_cg(params, heat, state, temp, False, int(n_sub), tol, maxiter)
    last_local["cg_iters"] = last_local.get("cg_iters", 0) + _cg_iterations(ws)
    return temp


def local_cg_steady(
    geom: Geometry,
    params: PhysParams,
    heat: HeatModel,
    state: SimState,
    temp: torch.Tensor,
    tol: float = 1e-10,
    maxiter: int = 1000,
) -> torch.Tensor:
    """The steady-state branch of the matrix-free local model
    (L T_tr = P*p_t solved as SPD (-L) T_tr = -P*p_t from 0)."""
    temp = temp.to(params.dtype).clone()
    ws = _run_local_cg(params, heat, state, temp, True, 0, tol, maxiter)
    last_local["cg_iters"] = last_local.get("cg_iters", 0) + _cg_iterations(ws)
    return temp


def finish_local_temperature(geom: Geometry, params: PhysParams, state, temp, ws=None):
    """Common tail of the local model: inner-region average -> T_bg.  A
    state whose scalars are 0-d device tensors keeps T_bg on the device; a
    host state gets it back with one read, together with the device loops'
    log ``ws.log`` (then :data:`last_local`)."""
    inner = geom.inner_mask
    T_bg = torch.where(inner, temp, 0.0).sum() / inner.sum()
    if not torch.is_tensor(state.T_bg):
        cg_mod.readbacks += 1
        if ws is None:
            T_bg = float(T_bg)
        else:
            T_bg, *log = torch.cat([T_bg.reshape(1).to(torch.float64),
                                    ws.log.to(torch.float64)]).tolist()
            note_local(*log)
    new_state = replace(state, temperature=temp.to(params.dtype), T_bg=T_bg)
    return new_state, {"Global temperature [K]": T_bg}


def update_temperature_local_cg(
    geom: Geometry,
    params: PhysParams,
    heat: HeatModel,
    state: SimState,
    step_time,
    tol: float = 1e-10,
    maxiter: int = 1000,
) -> Tuple[SimState, Dict]:
    """Matrix-free variant of :func:`update_temperature_local`: each
    transient substep solves (I - dt*tau*L) T' = rhs with CG (the reference
    precomputes the dense inverse instead, src/heat_solver.cpp:151-191); the
    steady-state branch solves L T = -P*p_t.  The device loops of
    ``ops.heat.run_cg``."""
    steady, n_sub = branch(params, step_time, geom.device)
    temp = state.temperature.to(params.dtype).clone()
    ws = _run_local_cg(params, heat, state, temp, steady, n_sub, tol, maxiter)
    return finish_local_temperature(geom, params, state, temp, ws)


def update_temperature(
    geom: Geometry,
    params: PhysParams,
    heat: Optional[HeatModel],
    state: SimState,
    step_time: float,
) -> Tuple[SimState, Dict]:
    """Dispatch matching Device::updateTemperature
    (src/heat_solver.cpp:250-312): the global model takes precedence."""
    if params.solve_heating_global:
        return update_temperature_global(params, state, step_time)
    if params.solve_heating_local and heat is not None and heat.n_interface:
        if heat.method == "cg":
            return update_temperature_local_cg(geom, params, heat, state, step_time)
        return update_temperature_local(geom, params, heat, state, step_time)
    return state, {}
