"""Blocked transport, dissipated power and heat under the halo decomposition,
the port of ``devicekmc_tpu/parallel/halo_transport.py``.

The single-device blocked operator (``physics.current.assemble_X_blocks``)
is an ELL neighbour part, three dense tunnel blocks over {vacancy, interior
metal} atoms, two virtual-node rows and an exact diagonal.  Here every large
piece of it is split over the ranks while the CG vectors stay whole on every
rank:

  * **atom rows** (the ELL values, the neighbour part of the dissipation
    sweep): ``world`` even chunks of the atom axis padded to ``Na_pad``;
    atoms follow the x-sorted site order, so these are x-slabs of atoms;
  * **T_cc** (metal_p x metal_p, the block that forces sharding at crossbar
    scale): chunks of the padded metal_p list's rows, stored per bias point
    (``halo_cc_rows``), whatever ``transport_cc`` says;
  * **T_vv, T_vm** (the vacancy blocks): chunks of the vacancy bucket's
    slots;
  * the CG vectors: each product makes this rank's rows, then one all-gather
    a row family and one all-reduce for the transposed ``T_vm`` product; the
    dots are computed on every rank over the same whole vectors, so every
    rank takes the same stop decisions with no reduction over the ranks.

The solve runs on the ``Na + 1`` leading entries (the last atom is the
ground reference), as the single device's does, so that its dots run over
the single device's entries; the operator reads and writes the padded
``[Na_pad + 2]`` vector.  Every entry is assembled with the single device's
helpers (``wkb_env``, ``tunnel_block``, the window kernel's wrapper for the
f32 ``T_vm`` rows, ``_pdisp_rows_cols``).

The local heat model (:func:`halo_heat_local_cg`) is the matrix-free model
of ``physics.heat`` on the slab: the Laplacian through the halo gather and
every dot and the inner-region mean summed over the ranks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops.cg import cg_solve, cg_solve_mixed, invert_coarse
from ..ops.compact import nonzero_fixed
from ..ops.wkb_window import wkb_window_block
from ..physics import heat as heat_mod
from ..physics.current import (
    DEFLATION_GATE_REL, G0, _cdtype, _dist_blocks, _forward_masks, _pdisp_rows_cols,
    require_ieee_f32, tunnel_block, wkb_env, wkb_single_T, wkb_window_T)
from ..state import Geometry, PhysParams
from ..structure import Element
from .mesh import Mesh

_V = int(Element.VACANCY)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def build_transport_static(geom: Geometry, params: PhysParams, elements: np.ndarray,
                           mesh: Mesh) -> Tuple[Dict, Dict]:
    """The static tables of the distributed transport phase, made on the
    host from the WHOLE geometry (before ``shard_halo_simulation``) and put
    on the rank's device: ``anb`` (the atom graph padded to ``Na_pad`` rows,
    pad -1) cut to this rank's ``Sa`` rows and ``site_atom`` (each site's
    atom slot, -1 else) cut to its slab; ``atom_ind_g``, ``arow_ok``, ``apos``,
    ``metal_a`` over the padded atom axis and the metal_p list padded to
    ``n_mp_pad`` (``mp_list``, ``mp_ok``, ``mp_inv``) whole.  ``elements``
    fixes the metal flags (no event makes or removes a metal).  Returns
    ``(tables, sizes)``: ``Na, Sa, Na_pad, n_mp, Smp, n_mp_pad``, each chunk
    rounded up to 8.  The rows run along the mesh's ``"sites"`` axis."""
    mesh = mesh.axis("sites")
    world, rank = mesh.world, mesh.rank
    Na = int(geom.N_atom)
    ai = geom.atom_ind.cpu().numpy()
    Sa = _round8(-(-Na // world))
    Na_pad = world * Sa

    anb = np.full((Na_pad, geom.max_nn), -1, np.int32)
    anb[:Na] = geom.atom_neigh_idx.cpu().numpy()
    atom_ind_g = np.zeros(Na_pad, np.int32)
    atom_ind_g[:Na] = ai
    arow_ok = np.zeros(Na_pad, bool)
    arow_ok[:Na] = True
    apos = np.zeros((Na_pad, 3), np.float64)
    apos[:Na] = geom.coords.cpu().numpy()[ai]
    metal_a = np.zeros(Na_pad, bool)
    metal_a[:Na] = geom.metal_mask_table.cpu().numpy()[np.asarray(elements)[ai]]

    mp_g = geom.atom_metalp_idx.cpu().numpy()
    n_mp = int(mp_g.shape[0])
    Smp = _round8(max(-(-n_mp // world), 1))
    n_mp_pad = world * Smp
    mp_list = np.zeros(n_mp_pad, np.int32)
    mp_list[:n_mp] = mp_g
    mp_ok = np.zeros(n_mp_pad, bool)
    mp_ok[:n_mp] = True
    mp_inv = np.full(Na_pad, -1, np.int32)
    mp_inv[mp_g] = np.arange(n_mp, dtype=np.int32)

    site_atom = np.full(geom.N, -1, np.int32)
    site_atom[ai] = np.arange(Na, dtype=np.int32)
    S = geom.N // world

    dev = mesh.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    tables = dict(
        anb=t(anb[rank * Sa:(rank + 1) * Sa]),
        site_atom=t(site_atom[rank * S:(rank + 1) * S]),
        atom_ind_g=t(atom_ind_g).long(), arow_ok=t(arow_ok),
        apos=t(apos).to(params.dtype), metal_a=t(metal_a),
        mp_list=t(mp_list).long(), mp_ok=t(mp_ok), mp_inv=t(mp_inv).long(),
    )
    sizes = dict(Na=Na, Sa=Sa, Na_pad=Na_pad, n_mp=n_mp, Smp=Smp, n_mp_pad=n_mp_pad)
    return tables, sizes


def _gather_atom_inputs(comm, params: PhysParams, ts, element, charge, CB_edge):
    """The whole structure's element, charge and CB edge (one all-gather
    each of the ranks' slabs) on the padded atom axis: pads DEFECT, 0, 0."""
    cdtype = _cdtype(params)
    ai, ok = ts["atom_ind_g"], ts["arow_ok"]
    aelem = torch.where(ok, comm.all_gather(element)[ai], int(Element.DEFECT))
    acharge = torch.where(ok, comm.all_gather(charge)[ai], 0)
    acb = torch.where(ok, comm.all_gather(CB_edge)[ai], 0.0).to(cdtype)
    return aelem, acharge, acb


def halo_cc_rows(geom: Geometry, params: PhysParams, comm, ts, sizes, element, charge,
                 CB_edge) -> torch.Tensor:
    """This rank's ``[Smp, n_mp_pad]`` rows of the metal_p x metal_p tunnel
    block (the per-bias-point cache, constant while the CB edge is), in the
    pairwise dtype; pad rows and columns exact zeros."""
    Smp = sizes["Smp"]
    _, _, acb = _gather_atom_inputs(comm, params, ts, element, charge, CB_edge)
    apos = ts["apos"].to(acb.dtype)
    mp_list, mp_ok = ts["mp_list"], ts["mp_ok"]
    mpos, mcb = apos[mp_list], acb[mp_list]
    my = slice(comm.rank * Smp, (comm.rank + 1) * Smp)
    return tunnel_block(wkb_env(geom, params), mpos[my], mcb[my], mp_ok[my], mpos, mcb,
                        mp_ok, wkb_single_T)


def _vm_rows(env, vpos, vcb, v_ok, mpos, mcb, mp_ok):
    """This rank's vacancy x metal_p window-integral rows: f32 entries
    through the window kernel's wrapper, its pad columns (``mp_ok`` False,
    which name atom 0) set to 0 after it; f64 through ``tunnel_block``."""
    if env["cdtype"] == torch.float32:
        T = wkb_window_block(vpos.contiguous(), vcb.contiguous(), v_ok.contiguous(),
                             mpos, mcb, env)
        return torch.where(mp_ok, T, 0.0)
    return tunnel_block(env, vpos, vcb, v_ok, mpos, mcb, mp_ok, wkb_window_T)


def assemble_halo_operator(sh, geom: Geometry, params: PhysParams, ts, sizes,
                           element, charge, CB_edge, T_cc_loc=None) -> Dict:
    """The row-split blocked operator (``current.assemble_X_blocks`` over the
    ranks).  Returns a dict of this rank's row chunks, the whole diagonal,
    ``int_needed`` (the integration steps the widest (vacancy, metal)
    pair needs, the largest over the ranks) and ``apply(x, wd)`` /
    ``apply_mat(X, wd)``: X x for a whole ``[Na_pad + 2]`` vector (``[.., K]``
    matrix) in the working dtype ``wd``, the tunnel blocks multiplying in
    their own dtype (f32 in mixed precision); every rank gets the whole
    product; ``place`` adds the metal and vacancy parts of a tunnel product
    to the atom rows.  ``T_cc_loc``: the rows of :func:`halo_cc_rows`, else
    made."""
    require_ieee_f32("the halo transport operator's f32 tunnel-block products")
    comm = sh.comm
    dtype = params.dtype
    cdtype = _cdtype(params)
    Na, Sa, Na_pad = sizes["Na"], sizes["Sa"], sizes["Na_pad"]
    Smp, n_mp_pad = sizes["Smp"], sizes["n_mp_pad"]
    d, world = comm.rank, comm.world
    dev = ts["apos"].device

    high_G = params.high_G * 1e5             # src/current_solver.cpp:9
    low_G = params.low_G
    loop_G = params.high_G * 1e7             # src/current_solver.cpp:8
    g_hi = torch.full((), -high_G, dtype=dtype, device=dev)
    g_lo = torch.full((), -low_G, dtype=dtype, device=dev)

    aelem, acharge, acb = _gather_atom_inputs(comm, params, ts, element, charge, CB_edge)
    apos = ts["apos"].to(cdtype)
    metal = ts["metal_a"]
    anyvac = ts["arow_ok"] & (aelem == _V)
    cvac = anyvac & (acharge == 0)

    # --- ELL values of my atom rows (exact dtype: they set the diagonal) ---
    anb = ts["anb"]
    valid = anb >= 0
    safe = anb.clamp(min=0).long()
    r0a = d * Sa
    my_a = slice(r0a, r0a + Sa)
    hi = (metal[my_a, None] & metal[safe]) | (cvac[my_a, None] & cvac[safe])
    nb_vals = torch.where(valid, torch.where(hi, g_hi, g_lo), 0.0)

    # --- tunnel rows: metal_p rows, vacancy-bucket slot rows ---
    env = wkb_env(geom, params)
    vcap = params.tunnel_vac_cap
    if vcap <= 0:
        raise ValueError("halo transport requires tunnel_vac_cap > 0")
    Svc = -(-vcap // world)
    vcap_pad = world * Svc
    vidx, n_vac = nonzero_fixed(anyvac, vcap, fill_value=0)
    v_ok = torch.arange(vcap, device=dev) < n_vac.clamp(max=vcap)
    vidx_p = torch.nn.functional.pad(vidx.long(), (0, vcap_pad - vcap))
    vok_p = torch.nn.functional.pad(v_ok, (0, vcap_pad - vcap))

    mp_list, mp_ok, mp_inv = ts["mp_list"], ts["mp_ok"], ts["mp_inv"]
    mpos, mcb = apos[mp_list], acb[mp_list]
    vpos, vcb = apos[vidx_p], acb[vidx_p]
    r0m, r0v = d * Smp, d * Svc
    my_m, my_v = slice(r0m, r0m + Smp), slice(r0v, r0v + Svc)

    if T_cc_loc is None:
        T_cc_loc = tunnel_block(env, mpos[my_m], mcb[my_m], mp_ok[my_m], mpos, mcb, mp_ok,
                                wkb_single_T)
    else:
        T_cc_loc = T_cc_loc.to(cdtype)
    T_vv_loc = tunnel_block(env, vpos[my_v], vcb[my_v], vok_p[my_v], vpos, vcb, vok_p,
                            wkb_single_T)
    T_vm_loc = _vm_rows(env, vpos[my_v], vcb[my_v], vok_p[my_v], mpos, mcb, mp_ok)

    # the exactness check of the integration trip count on my slot rows,
    # the largest over the ranks
    dist_vm = _dist_blocks(vpos[my_v], mpos, env["lattice"], env["pbc"])
    abs_vm = torch.abs(vcb[my_v, None] - mcb[None, :])
    elig_vm = (vok_p[my_v, None] & mp_ok[None, :] & (abs_vm > env["ctol"])
               & ~(dist_vm < env["nn"]))
    widest = torch.where(elig_vm, abs_vm, 0.0).max()
    int_needed = comm.all_reduce(
        torch.ceil(widest / env["dE_step"]).to(torch.int32).reshape(1), op="max")[0]

    # --- virtual-node rows and the exact diagonal (whole on every rank) ---
    nsi, nge = params.num_source_inj, params.num_ground_ext
    aidx = torch.arange(Na_pad, device=dev)
    src_vals = torch.where(aidx < nsi, g_hi, 0.0)
    # strict ">" keeps the reference's off-by-one (src/current_solver.cpp:187)
    gnd_vals = torch.where((aidx > Na - nge) & (aidx < Na), g_hi, 0.0)

    row_atoms = comm.all_gather(nb_vals.sum(dim=1)) + gnd_vals + src_vals
    cc_row = comm.all_gather(T_cc_loc.sum(dim=1).to(dtype))
    mv_row = comm.all_reduce(T_vm_loc.sum(dim=0)).to(dtype)
    vv_row = comm.all_gather(T_vv_loc.sum(dim=1).to(dtype))
    vm_row = comm.all_gather(T_vm_loc.sum(dim=1).to(dtype))
    # index_add_: the pad entries of mp_list and vidx_p all name atom 0
    row_atoms.index_add_(0, mp_list, torch.where(mp_ok, cc_row + mv_row, 0.0))
    row_atoms.index_add_(0, vidx_p, torch.where(vok_p, vv_row + vm_row, 0.0))
    row0 = gnd_vals.sum() - loop_G
    row1 = src_vals.sum() - loop_G
    diag = -torch.cat([torch.stack([row0, row1]), row_atoms])
    # the grounded atom and the pads: no row, no column
    mask = torch.arange(Na_pad + 2, device=dev) < Na + 1
    mp_gather = torch.where(mp_inv >= 0, mp_inv, n_mp_pad)

    def place(Ya, Y_cc, Y_mv, Y_v, wd):
        """The metal_p part (a gather through the inverse map) and the
        vacancy part (a scatter-add) of a tunnel product, added to ``Ya``."""
        Y_mp = (Y_cc + Y_mv).to(wd)
        Y_mp = torch.cat([Y_mp, torch.zeros_like(Y_mp[:1])])
        ok = vok_p if Y_v.dim() == 1 else vok_p[:, None]
        return (Ya + Y_mp[mp_gather]).index_add_(0, vidx_p, torch.where(ok, Y_v.to(wd), 0.0))

    def apply(x, wd):
        x = torch.where(mask, x, 0.0).to(wd)
        x0, x1, xa = x[0], x[1], x[2:]
        ya = comm.all_gather((nb_vals.to(wd) * xa[safe]).sum(dim=1))
        xm = xa[mp_list].to(cdtype)      # pad entries meet zero columns
        xv = torch.where(vok_p, xa[vidx_p], 0.0).to(cdtype)
        y_cc = comm.all_gather(T_cc_loc @ xm)
        y_mv = comm.all_reduce(xv[my_v] @ T_vm_loc)
        y_v = comm.all_gather(T_vv_loc @ xv + T_vm_loc @ xm)
        ya = place(ya, y_cc, y_mv, y_v, wd)
        src, gnd = src_vals.to(wd), gnd_vals.to(wd)
        ya = ya + gnd * x0 + src * x1
        y0 = torch.dot(gnd[:Na], xa[:Na]) - loop_G * x1
        y1 = torch.dot(src[:Na], xa[:Na]) - loop_G * x0
        y = torch.cat([torch.stack([y0, y1]), ya]) + diag.to(wd) * x
        return torch.where(mask, y, 0.0)

    def apply_mat(X, wd):
        """Y = X_op X for K whole columns (the deflation basis): the tunnel
        rows read once for all columns, the ELL part a slot at a time."""
        X = torch.where(mask[:, None], X, 0.0).to(wd)
        x0, x1, Xa = X[0], X[1], X[2:]
        nbw = nb_vals.to(wd)
        Ya = torch.zeros((Sa, X.shape[1]), dtype=wd, device=dev)
        for s in range(nbw.shape[1]):
            Ya = Ya + nbw[:, s:s + 1] * Xa[safe[:, s]]
        Ya = comm.all_gather(Ya)
        Xm = Xa[mp_list].to(cdtype)
        Xv = torch.where(vok_p[:, None], Xa[vidx_p], 0.0).to(cdtype)
        Y_cc = comm.all_gather(T_cc_loc @ Xm)
        Y_mv = comm.all_reduce(T_vm_loc.T @ Xv[my_v])
        Y_v = comm.all_gather(T_vv_loc @ Xv + T_vm_loc @ Xm)
        Ya = place(Ya, Y_cc, Y_mv, Y_v, wd)
        src, gnd = src_vals.to(wd), gnd_vals.to(wd)
        Ya = Ya + gnd[:, None] * x0[None, :] + src[:, None] * x1[None, :]
        y0 = gnd[:Na] @ Xa[:Na] - loop_G * x1
        y1 = src[:Na] @ Xa[:Na] - loop_G * x0
        Y = torch.cat([torch.stack([y0, y1]), Ya]) + diag.to(wd)[:, None] * X
        return torch.where(mask[:, None], Y, 0.0)

    return dict(
        apply=apply, apply_mat=apply_mat, diag=diag, place=place,
        nb_vals=nb_vals, safe=safe, T_cc_loc=T_cc_loc, T_vv_loc=T_vv_loc, T_vm_loc=T_vm_loc,
        mp_list=mp_list, vidx_p=vidx_p, vok_p=vok_p, gnd_vals=gnd_vals, loop_G=loop_G,
        int_needed=int_needed, anyvac=anyvac, metal=metal, aidx=aidx,
        r0a=r0a, r0m=r0m, r0v=r0v, Svc=Svc,
    )


def _halo_deflation_ops(params: PhysParams, ts, sizes, op, d):
    """The A-DEF2 coarse space of the halo solve in the Jacobi-scaled metric
    (``current._deflation_ops``): ``coarse_slabs`` x-slabs of the atoms of
    the grounded subsystem (the two virtual nodes, the grounded atom and the
    pads in none), over the solve's ``Nsub = Na + 1`` entries.  Every rank
    computes the same coarse quantities from the whole vectors.  Returns
    (Zhat, W, esolve)."""
    dtype = params.dtype
    K = params.coarse_slabs
    Na, Na_pad = sizes["Na"], sizes["Na_pad"]
    Nsub = Na + 1
    ax = ts["apos"][:, 0].to(dtype)
    sel = ts["arow_ok"] & (torch.arange(Na_pad, device=ax.device) < Na - 1)
    xmin = torch.where(sel, ax, torch.inf).min()
    xmax = torch.where(sel, ax, -torch.inf).max()
    slab = torch.clamp(
        ((ax - xmin) / torch.clamp(xmax - xmin, min=1e-30) * K).to(torch.int32), 0, K - 1)
    agg = torch.where(sel, slab, K).long()
    Z_atoms = torch.nn.functional.one_hot(agg, K + 1)[:, :K].to(dtype)
    Zm = torch.cat([torch.zeros((2, K), dtype=dtype, device=ax.device), Z_atoms])
    # A Z in full precision even in mixed mode (E's conditioning, ~1e10)
    AZ = op["apply_mat"](Zm, dtype)[:Nsub]
    Zm = Zm[:Nsub]
    E = Zm.T @ AZ
    E_inv = invert_coarse(E)

    def esolve(a):
        # one refinement round on the K x K solve
        c = E_inv @ a
        return c + E_inv @ (a - E @ c)

    ds = torch.sqrt(torch.where(d > 0, d, 1.0))
    return ds[:, None] * Zm, AZ / ds[:, None], esolve


def halo_transport_power(sh, geom: Geometry, params: PhysParams, ts, sizes,
                         element, charge, CB_edge, vp_prev, Vd: float, T_cc_loc=None,
                         cg_maxiter: int = 20000):
    """The transport solve and power extraction over the ranks
    (``current.update_power_blocked``), every superstep, with no
    unchanged-network skip.  Returns ``(vp_new [Na + 2], I_macro (float),
    atom_power [Na_pad] whole on every rank, P_tot (float), metrics)``; the
    caller puts ``atom_power`` on its slab's sites.  The solve: mixed (f32
    CG with f64 refinement, deflated or Jacobi), f64 deflated, or f64
    Jacobi, as ``params`` say."""
    dtype = params.dtype
    Na, Na_pad = sizes["Na"], sizes["Na_pad"]
    Nsub = Na + 1
    nsi = params.num_source_inj
    dev = ts["apos"].device

    op = assemble_halo_operator(sh, geom, params, ts, sizes, element, charge, CB_edge,
                                T_cc_loc=T_cc_loc)
    apply, diag = op["apply"], op["diag"]
    loop_G = op["loop_G"]

    def apply_sub(x_sub, wd):
        x = torch.cat([x_sub, torch.zeros(Na_pad + 2 - Nsub, dtype=x_sub.dtype, device=dev)])
        return apply(x, wd)[:Nsub]

    rhs = torch.zeros(Nsub, dtype=dtype, device=dev)
    rhs[0] = -loop_G * Vd
    rhs[1] = loop_G * Vd
    d = diag[:Nsub]
    x_init = vp_prev[:Nsub].to(dtype)
    cg_tol = params.transport_tol

    deflate = params.transport_precond == "deflated"
    if deflate:
        Zhat, W, esolve = _halo_deflation_ops(params, ts, sizes, op, d)
    if params.mixed:
        dsi = 1.0 / torch.sqrt(torch.where(d > 0, d, 1.0))
        dsi32 = dsi.to(torch.float32)
        inner_precond = inner_start = None
        if deflate:
            Zh32, W32 = Zhat.to(torch.float32), W.to(torch.float32)

            def _coarse_f32(coeff):
                # the coarse solve stays f64; cast at the boundary only
                return esolve(coeff.to(dtype)).to(torch.float32)

            def inner_precond(r, gate):
                if not gate:
                    return r
                return r + Zh32 @ _coarse_f32(Zh32.T @ r - W32.T @ r)

            def inner_start(b, gate):
                if not gate:
                    return torch.zeros_like(b)
                return Zh32 @ _coarse_f32(Zh32.T @ b)

        res = cg_solve_mixed(
            lambda y: dsi * apply_sub(dsi * y, dtype),
            lambda y: dsi32 * apply_sub(dsi32 * y, torch.float32),
            rhs * dsi, x0=x_init / dsi,
            tol=cg_tol, inner_tol=1e-5, inner_maxiter=400, maxiter=cg_maxiter,
            inner_precond=inner_precond, inner_start=inner_start,
            inner_gate_rel=DEFLATION_GATE_REL if deflate else None,
        )
        v = res.x * dsi
    elif deflate:
        # criterion "r" on the scaled system is the Jacobi criterion on the
        # unscaled one
        ds = torch.sqrt(torch.where(d > 0, d, 1.0))
        dsi = 1.0 / ds
        b_s = rhs * dsi
        y0 = x_init * ds
        y0 = y0 - Zhat @ esolve(W.T @ y0) + Zhat @ esolve(Zhat.T @ b_s)
        res = cg_solve(
            lambda y: dsi * apply_sub(dsi * y, dtype), b_s, x0=y0,
            precond=lambda r: r + Zhat @ esolve(Zhat.T @ r - W.T @ r),
            tol=cg_tol, maxiter=cg_maxiter, criterion="r",
        )
        v = res.x * dsi
    else:
        res = cg_solve(lambda x: apply_sub(x, dtype), rhs, x0=x_init, diag=d, tol=cg_tol,
                       maxiter=cg_maxiter, criterion="pre")
        v = res.x

    Matoms = torch.cat([v[2:] * G0, torch.zeros(Na_pad - Na + 1, dtype=dtype, device=dev)])
    I_macro_t = torch.sum(op["gnd_vals"][:Na] * (v[0] * G0 - Matoms[:Na]))

    solve_heat = params.solve_heating_global or params.solve_heating_local
    if solve_heat:
        atom_power = halo_atom_power(sh, params, op, sizes, Matoms, Vd)
        P_tot_t = atom_power[:Na].sum()
    else:
        atom_power = torch.zeros(Na_pad, dtype=dtype, device=dev)
        P_tot_t = torch.zeros((), dtype=dtype, device=dev)

    # one read: the current, the power, the contact drop and the counts
    I_macro, P_tot, contact_drop, n_vac, int_needed = torch.stack([
        t.to(torch.float64) for t in (
            I_macro_t, P_tot_t, torch.abs(v[nsi] - Vd), op["anyvac"].sum(),
            op["int_needed"])]).tolist()
    vp_new = torch.cat([v, torch.zeros(1, dtype=dtype, device=dev)])
    metrics = {
        "n_vac_atoms": int(n_vac),
        "Current [uA]": I_macro * 1e6,
        "Conductance [uS]": abs(I_macro / (Vd if Vd != 0 else 1.0)) * 1e6,
        "cg_iters_power": res.iters,
        "transport_converged": res.converged,
        "contact_potential_drop": contact_drop,
        "tunnel_int_steps_needed": int(int_needed),
    }
    if solve_heat:
        metrics["Total dissipated power [mW]"] = P_tot * 1e3
    return vp_new, I_macro, atom_power, P_tot, metrics


def halo_atom_power(sh, params: PhysParams, op, sizes, Matoms, Vd: float) -> torch.Tensor:
    """The atoms' dissipated power [Na_pad], whole on every rank, from the
    atoms' potentials times G0 ``Matoms`` [Na_pad] (pads 0): the
    forward-current sums of :func:`_halo_pdisp`, none for metal atoms and
    the injection and extraction layers (``current._site_power``)."""
    Na, nsi = sizes["Na"], params.num_source_inj
    P_disp = _halo_pdisp(sh, op, sizes, Matoms, Vd)
    aidx = op["aidx"]
    in_range = (aidx >= nsi) & (aidx < Na - nsi)
    return torch.where(in_range & ~op["metal"], -P_disp, 0.0).to(params.dtype)


def _halo_pdisp(sh, op, sizes, Matoms, Vd: float) -> torch.Tensor:
    """Per-atom forward-current dissipation sums [Na_pad] (``current.
    _pdisp_blocked`` over the ranks): my atom rows of the ELL part and my
    rows of the three tunnel blocks, each row family all-gathered, the
    transposed ``T_vm`` part summed over the ranks."""
    comm = sh.comm
    Na, Sa, Smp = sizes["Na"], sizes["Sa"], sizes["Smp"]
    Svc, r0a, r0m, r0v = op["Svc"], op["r0a"], op["r0m"], op["r0v"]
    Ms = Matoms + torch.abs(Matoms[:Na].min())
    dM_nb = Ms[r0a:r0a + Sa, None] - Ms[op["safe"]]
    I_cal = op["nb_vals"] * dM_nb
    fwd, _ = _forward_masks(I_cal, Vd)
    P_disp = comm.all_gather((torch.where(fwd, -I_cal, 0.0) * (-dM_nb)).sum(dim=1))

    vok_p = op["vok_p"]
    ms_m = Ms[op["mp_list"]]
    ms_v = torch.where(vok_p, Ms[op["vidx_p"]], 0.0)
    cc_r, _ = _pdisp_rows_cols(op["T_cc_loc"], ms_m[r0m:r0m + Smp], ms_m, Vd)
    vv_r, _ = _pdisp_rows_cols(op["T_vv_loc"], ms_v[r0v:r0v + Svc], ms_v, Vd)
    vm_r, vm_c = _pdisp_rows_cols(op["T_vm_loc"], ms_v[r0v:r0v + Svc], ms_m, Vd)
    return op["place"](P_disp, comm.all_gather(cc_r), comm.all_reduce(vm_c),
                       comm.all_gather(vv_r) + comm.all_gather(vm_r), P_disp.dtype)


# ----------------------------------------------------------------------------
# the local heat model over the ranks
# ----------------------------------------------------------------------------

def _dist_cg_plain(sh, matvec, b, x0, tol: float, maxiter: int):
    """CG with M = I and criterion "r" (``ops.cg.cg_solve``'s defaults) on
    slab vectors, every dot summed over the ranks; the local heat model's
    substep solves."""
    return cg_solve(matvec, b, x0=x0, tol=tol, maxiter=maxiter, dot=sh.pdot)


def halo_heat_local_cg(sh, geom: Geometry, params: PhysParams, heat, element, power,
                       temperature, step_time: float, tol: float = 1e-10,
                       maxiter: int = 1000):
    """The matrix-free local temperature on the slab
    (``heat.update_temperature_local_cg``): the interface Laplacian through
    the halo gather, each substep's CG (or the steady state's) with its dots
    summed over the ranks, T_bg the inner region's mean over the ranks.
    ``heat`` is this rank's slab of the model.  Returns (temperature, T_bg
    (float), metrics)."""
    f = heat_mod._npd(params)
    dtype = params.dtype
    T0 = float(f(params.background_temp))
    scale = float(f(C.T_1) - f(T0))
    mask = heat.interface_mask
    p_t = torch.where(mask, heat_mod._p_transfer(params, element), 0.0)
    P_full = torch.where(mask, power, 0.0)
    s = heat.step_scale

    nb_int = sh.gather(mask) & sh.valid
    lap_diag = heat.diag_base - nb_int.sum(dim=1).to(dtype)

    def lap(x):
        xm = torch.where(mask, x, 0.0)
        off = torch.where(nb_int, sh.gather(xm), 0.0).sum(dim=1)
        return torch.where(mask, lap_diag * x + off, 0.0)

    temp = temperature
    iters = 0
    if heat_mod.is_steady(params, step_time):
        n_sub, branch = 0, "steady"
        rhs = torch.where(mask, -P_full * p_t, 0.0)
        res = _dist_cg_plain(sh, lambda x: torch.where(mask, -lap(x), 0.0), rhs,
                             torch.zeros_like(rhs), tol, maxiter)
        iters = res.iters
        temp = torch.where(mask, -res.x * scale + T0, temp)
    else:
        n_sub, branch = heat_mod.n_substeps(params, step_time), "transient"
        src = P_full * p_t * s
        for _ in range(n_sub):
            t_vec = torch.where(mask, (temp - T0) / scale, 0.0)
            rhs = torch.where(mask, t_vec + src, 0.0)
            res = _dist_cg_plain(sh, lambda x: torch.where(mask, x - s * lap(x), 0.0), rhs,
                                 t_vec, tol, maxiter)
            iters += res.iters
            temp = torch.where(mask, res.x * scale + T0, temp)
    heat_mod.last_local.update(branch=branch, substeps=n_sub, cg_iters=iters)
    inner = geom.inner_mask
    sums = sh.psum(torch.stack([sh.rows(torch.where(inner, temp, 0.0)).sum(),
                                sh.rows(inner).sum().to(temp.dtype)]))
    T_bg = float(sums[0] / sums[1])
    return temp.to(dtype), T_bg, {"Global temperature [K]": T_bg}
