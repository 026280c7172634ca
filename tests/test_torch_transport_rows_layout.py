"""The inputs of the f64 transport rows kernel on the CPU
(``ops/transport_cg.py``, ``csrc/transport_cg.cu`` transport_rows_kernel):
the atom graph as a sliced ELL (``atom_slices``, made once for a structure:
``physics/current.py`` ``atom_graph_slices``) and each slot's conductance
from the two atoms' classes against the assembly's ``nb_vals`` and the JAX
package's ``G_nb``; and the f64 and mixed CPU solves, which never read the
layout, against the host-loop CG bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import configs, small_structure, to_port

torch.set_num_threads(1)

#: the structures whose atom graphs are sliced: the 256-site stack of the
#: parity tests and a synthetic crossbar of about 6,000 sites (the card
#: tests' crossbar: many slices, rows of every length)
STRUCTURES = ["stack", "crossbar"]


def _geometry(name):
    """The geometry of structure ``name`` on the CPU."""
    from devicekmc_tpu_torch.state import build_geometry

    if name == "stack":
        s = small_structure()
        nn = 3.0
    else:
        from devicekmc_tpu_torch.structure import make_crossbar_structure

        s = make_crossbar_structure(nx_contact=10, nx_oxide=24, ny=10, nz=10, seed=1)
        nn = 3.5
    _, tcfg = configs(s, nn_dist=nn, pbc=False, solve_current=True, transport="blocked")
    return build_geometry(s.elements, s.coords, tcfg, device="cpu")


@pytest.fixture(scope="module", params=STRUCTURES)
def geom(request):
    return _geometry(request.param)


@pytest.fixture(scope="module")
def graph(geom):
    """The structure's atom graph [Na, max_nn] (int32, pad -1)."""
    return geom.atom_neigh_idx


def _slice_rows(idx, start, nsub):
    """Each row's slots [nsub, width] of the layout (width: the widest
    slice's; -2 past a slice's own width), as numpy."""
    from devicekmc_tpu_torch.ops.transport_cg import ATOM_SLICE

    idx, start = idx.numpy(), start.numpy().astype(np.int64)
    widths = np.diff(start) // ATOM_SLICE
    out = np.full((nsub, max(int(widths.max()), 1)), -2, dtype=np.int64)
    for i in range(nsub):
        s, lane = divmod(i, ATOM_SLICE)
        w = widths[s]
        out[i, :w] = idx[start[s] + np.arange(w) * ATOM_SLICE + lane]
    return out


def test_atom_slices_hold_each_rows_neighbours_in_order(graph):
    """atom_slices: int32 indices and slice starts; each slice ATOM_SLICE
    rows wide as its longest row; row i (atom i - 2; rows 0 and 1 the
    virtual nodes, no slot) holds its atom's valid neighbours once each, in
    the atom graph's order, then pads (-1) alone."""
    from devicekmc_tpu_torch.ops.transport_cg import ATOM_SLICE, atom_slices

    anb = graph
    na = anb.shape[0]
    nsub = na + 1
    idx, start = atom_slices(anb)
    assert idx.dtype == start.dtype == torch.int32
    n_sl = -(-nsub // ATOM_SLICE)
    assert start.shape == (n_sl + 1,) and int(start[0]) == 0 and int(start[-1]) == idx.numel()
    rows = _slice_rows(idx, start, nsub)
    a = anb.numpy()
    counts = np.zeros(n_sl * ATOM_SLICE, dtype=np.int64)
    counts[2:nsub] = (a[:na - 1] >= 0).sum(axis=1)
    widths = np.diff(start.numpy()) // ATOM_SLICE
    assert np.array_equal(widths, counts.reshape(n_sl, ATOM_SLICE).max(axis=1))
    for i in range(nsub):
        want = a[i - 2][a[i - 2] >= 0] if i >= 2 else np.zeros(0, dtype=a.dtype)
        row = rows[i][rows[i] != -2]
        assert np.array_equal(row[:want.size], want), i
        assert (row[want.size:] == -1).all(), i
    # the slots the kernel reads: the valid ones of the rows, each once
    assert int((idx >= 0).sum()) == int((anb[:na - 1] >= 0).sum())


def test_atom_graph_slices_made_once_a_structure(geom):
    """atom_graph_slices: atom_slices of the structure's atom graph, made at
    the first call and the same tensors at every later one, also through a
    geometry that shares the graph (dataclasses.replace)."""
    from devicekmc_tpu_torch.ops.transport_cg import atom_slices
    from devicekmc_tpu_torch.physics.current import atom_graph_slices

    idx, start = atom_graph_slices(geom)
    want = atom_slices(geom.atom_neigh_idx)
    assert torch.equal(idx, want[0]) and torch.equal(start, want[1])
    again = atom_graph_slices(dataclasses.replace(geom, coords=geom.coords.clone()))
    assert again[0] is idx and again[1] is start


# ---------------------------------------------------------------------------
# the conductances from the atoms' classes
# ---------------------------------------------------------------------------

VD = 2.0
#: the states of the class check: the pristine stack; 8 oxygen vacancies,
#: all neutral; the same, half of them charged; the state after three
#: supersteps of the port at 10 V (charges from the charge rule)
STATES = ["pristine", "neutral vacancies", "charged vacancies", "after supersteps"]


@pytest.fixture(scope="module")
def stack():
    """The small stack's JAX geometry, parameters, state and configurations
    (f64)."""
    from devicekmc_tpu.state import build_geometry, build_params, init_state

    s = small_structure()
    jcfg, tcfg = configs(s, pbc=False, solve_current=True, transport="blocked")
    jg = build_geometry(s.elements, s.coords, jcfg)
    return dict(s=s, jcfg=jcfg, tcfg=tcfg, jg=jg, jp=build_params(jcfg),
                js=init_state(jg, jcfg, s.elements))


def _state(stack, kind, tmp_path):
    """The JAX state of ``kind`` on the stack's geometry."""
    import jax.numpy as jnp
    from devicekmc_tpu.structure import Element

    js = stack["js"]
    elem = np.asarray(js.element).copy()
    if kind == "pristine":
        return js
    if kind == "after supersteps":
        from devicekmc_tpu_torch.engine import Simulation

        _, tcfg = configs(stack["s"], pbc=False, pristine=True,
                          initial_vacancy_concentration=0.08, rnd_seed=3, rnd_seed_kmc=7,
                          V_switch=[10.0], t_switch=[1e30], output_dir=str(tmp_path))
        sim = Simulation(tcfg, elements=stack["s"].elements, coords=stack["s"].coords,
                         device="cpu")
        sim.run_bias_point(10.0, 1e30, max_steps=3)
        assert int((sim.state.element == int(Element.VACANCY)).sum()) > 0
        assert int((sim.state.charge != 0).sum()) > 0
        return js.replace(element=jnp.asarray(sim.state.element.numpy(), jnp.int32),
                          charge=jnp.asarray(sim.state.charge.numpy(), jnp.int32))
    rng = np.random.default_rng(5)
    ox = np.nonzero(elem == int(Element.O))[0]
    vac = rng.choice(ox, size=8, replace=False)
    elem[vac] = int(Element.VACANCY)
    charge = np.zeros_like(elem)
    if kind == "charged vacancies":
        charge[vac[::2]] = 2
    return js.replace(element=jnp.asarray(elem, jnp.int32),
                      charge=jnp.asarray(charge, jnp.int32))


def _slot_conductances(anb, cls, g_hi, g_lo):
    """Each slot's conductance [Na, max_nn] as transport_rows_kernel makes it
    (0 at a pad): ``g_hi`` where the two atoms' classes share a bit (both
    metal, or both neutral vacancies), else ``g_lo``."""
    c = cls.to(torch.int32)
    hi = (c[:, None] & c[anb.clamp(min=0).long()]) != 0
    g = torch.where(hi, torch.full((), g_hi, dtype=torch.float64),
                    torch.full((), g_lo, dtype=torch.float64))
    return torch.where(anb >= 0, g, 0.0)


@pytest.mark.parametrize("kind", STATES)
def test_class_conductances_equal_nb_vals_and_jax(stack, kind, tmp_path):
    """The conductance the f64 rows kernel gives each slot, from the
    assembly's atom classes and its two conductances (_slot_conductances):
    bit for bit the assembly's nb_vals at every slot (pads 0),
    and at every valid slot the JAX package's -G_nb (its dense X's
    neighbour entries, f64); both constants in use where vacancies are."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu.structure import Element
    from devicekmc_tpu_torch.physics import current as tcur
    from devicekmc_tpu_torch.state import build_params

    js = _state(stack, kind, tmp_path)
    tg, ts = to_port(stack["jg"], js)
    n_vac = int((ts.element == int(Element.VACANCY)).sum())
    tp = dataclasses.replace(build_params(stack["tcfg"]), transport="blocked",
                             tunnel_vac_cap=max(16, n_vac + 4), transport_cc="stored")
    blk = tcur.assemble_X_blocks(tg, tp, ts)
    assert blk["atom_class"].dtype == torch.uint8
    g = _slot_conductances(tg.atom_neigh_idx, blk["atom_class"], blk["g_hi"], blk["g_lo"])
    assert g.dtype == blk["nb_vals"].dtype == torch.float64
    assert torch.equal(g, blk["nb_vals"])
    valid = tg.atom_neigh_idx >= 0
    assert bool((g[valid] == blk["g_hi"]).any()) and bool((g[valid] == blk["g_lo"]).any())
    if kind in ("neutral vacancies", "charged vacancies"):
        assert bool(((blk["atom_class"] & 2) != 0).any())
    X = np.asarray(jcur.assemble_X(stack["jg"], stack["jp"], js, VD)[0])
    assert X.dtype == np.float64
    a, k = np.nonzero(valid.numpy())
    b = tg.atom_neigh_idx.numpy()[a, k]
    np.testing.assert_array_equal(X[2 + a, 2 + b], g.numpy()[a, k])


# ---------------------------------------------------------------------------
# the CPU solves: the plain versions, bit for bit the host-loop CG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_cpu_solve_unchanged(tmp_path, precision):
    """The warm re-solve's device form on the CPU (transport_cg.solve_f64 or
    solve through the plain versions, the operator holding the structure's
    atom slices, which no plain version reads) against update_power_blocked's
    host-loop CG (ops.cg.cg_solve with criterion "pre", or cg_solve_mixed)
    on the same state of the stored configuration after two supersteps: the
    same iterations, the same potentials and I_macro bit for bit."""
    from torch_transport_graph import F64, STORED, VD as TVD, _port

    from devicekmc_tpu_torch.ops import transport_cg
    from devicekmc_tpu_torch.physics import current

    sim = _port(tmp_path, f"solve_{precision}", eager=True,
                **(F64 if precision == "f64" else STORED))
    sim.run_bias_point(TVD, 1e30, max_steps=2)
    rng = np.random.default_rng(0)
    vp = sim.state.virtual_potentials
    vp = vp * torch.as_tensor(1 + 1e-2 * rng.standard_normal(vp.shape[0]))
    st = dataclasses.replace(sim.state, virtual_potentials=vp, transport_Vd_prev=float("nan"))
    cc = dict(sim._cc)
    assert current.warm_device_form(sim.params, cc, "jacobi")
    seen = {}
    name = "solve_f64" if precision == "f64" else "solve"
    solve = getattr(transport_cg, name)

    def grab(tws, op, *args, **kw):
        seen["op"] = op
        return solve(tws, op, *args, **kw)

    setattr(transport_cg, name, grab)
    try:
        got, mg = current.update_power(sim.geom, sim.params, st, TVD, cc=cc, allow_skip=True)
    finally:
        setattr(transport_cg, name, solve)
    ref, mr = current.update_power_blocked(sim.geom, sim.params, st, TVD, cc=sim._cc,
                                           precond="jacobi")
    idx, start = current.atom_graph_slices(sim.geom)
    assert seen["op"].nb_idx is idx and seen["op"].nb_start is start
    assert mg["transport_converged"] and mr["transport_converged"]
    assert mg["cg_iters_power"] == mr["cg_iters_power"] > 0
    assert got.I_macro == ref.I_macro
    assert torch.equal(got.virtual_potentials, ref.virtual_potentials)
