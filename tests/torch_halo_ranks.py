"""One rank of the halo decomposition's CPU tests (tests/test_torch_halo.py).

    python tests/torch_halo_ranks.py WORKDIR RANK WORLD [CASES]

Joins a gloo group of WORLD ranks through a file rendezvous in WORKDIR, runs
the cases (CASES: comma-separated names, default ``exchange,laplace,run,
raises``, tests/test_torch_halo.py's) on its slab and writes what it saw to
``WORKDIR/rank<RANK>.npz`` (arrays) and ``WORKDIR/rank<RANK>.json`` (counts,
messages).  Imports no JAX: the test process holds the results against the
JAX package.

Cases:
  * ``exchange``: the halo exchange in groups of 1, 2 and 4 ranks, int32,
    float32, float64 and an int32 [S, 2] slab, halo widths 0, 3 and S;
  * ``laplace``: ``make_halo_laplace_solver`` on the slabs of
    ``WORKDIR/laplace.npz``;
  * ``run``: ``Simulation(..., decomposition="halo")`` on the 184-site stack
    of tests/test_halo_superstep.py, 8 supersteps at 4 V (one event a
    step), and again as ``fast`` with every barrier scaled by 0.2 (59
    events over the 8 steps, picked in every slab);
  * ``raises``: the errors a configuration or a mesh must raise (and the
    replicated decomposition, which raised before it was ported, running);
  * ``transport`` (tests/test_torch_halo_transport.py): the halo transport's
    functions on the inputs of ``WORKDIR/transport.npz`` (the operator and
    its matrix form in f64 and mixed precision, the transport solve and the
    power, the local heat model in both branches), then the stack of
    ``run`` with blocked transport, 8 supersteps with global heat and 8
    with local (cg) heat.
"""

import dataclasses
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: the exchange cases' slab rows and halo widths
EX_ROWS = 8
EX_HALOS = (0, 3, EX_ROWS)
#: the run case: the stack, its bias and steps
RUN_STACK = dict(nx_contact=2, nx_oxide=28, ny=2, nz=2, seed=5)
RUN_VD = 4.0
RUN_STEPS = 8
#: the run cases: the barriers' scale of each
RUN_CASES = {"run": 1.0, "fast": 0.2}
#: a stack whose graph bandwidth (275) exceeds a 4-rank slab (256 sites)
WIDE_STACK = dict(nx_contact=2, nx_oxide=4, ny=10, nz=10, seed=1)
#: the cases a bare command line runs
DEFAULT_CASES = ("exchange", "laplace", "run", "raises")

#: the transport cases' configuration on the ``run`` stack (the JAX halo
#: test's full-physics one) and the heat variants of the whole runs
TRANSPORT = dict(solve_current=True, transport="blocked", A=6.25e-19)
HEAT_CASES = {"global": dict(solve_heating_global=True),
              "local": dict(solve_heating_local=True, heat_solver="cg", delta_t=1e-14)}
#: the module cases' settings: a vacancy bucket that does not split evenly
#: over 4 ranks, the solve's tolerance, the columns of the matrix product,
#: the bias, and the local heat model's step times (transient, steady)
MODULE = dict(tunnel_vac_cap=50, transport_tol=1e-11)
MODULE_K = 3
MODULE_VD = 4.0
HEAT_STEP_TIMES = (5e-14, 1e-10)


def exchange_global(world, dtype, seed):
    """The global vector the exchange case splits over ``world`` ranks."""
    rng = np.random.default_rng(seed)
    n = world * EX_ROWS
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)
    if dtype == "int32x2":
        return rng.integers(-2**31, 2**31 - 1, size=(n, 2), dtype=np.int64).astype(np.int32)
    return rng.standard_normal(n).astype(dtype)


def run_config(out_dir, barrier_scale=1.0, **over):
    """The port's configuration of tests/test_halo_superstep.py's ``_cfg``,
    every layer's barriers scaled by ``barrier_scale``."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(**over.pop("stack", RUN_STACK))
    layers = [dataclasses.replace(l, **{e: getattr(l, e) * barrier_scale for e in (
        "E_gen_0", "E_rec_1", "E_diff_2", "E_diff_3")}) for l in s.layers]
    base = dict(
        lattice=list(s.lattice), nn_dist=3.0, pbc=False,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=layers,
        solve_potential=True, solve_current=False, perturb_structure=True,
        pristine=True, initial_vacancy_concentration=0.15,
        V_switch=[RUN_VD], t_switch=[1e30], log_freq=1000,
        output_dir=str(out_dir), active_rows_cap=0, event_mode="incremental",
    )
    base.update(over)
    return KMCConfig(**base), s


def case_exchange(rank, world, arrays):
    from devicekmc_tpu_torch.parallel.mesh import Communicator

    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]), world: dist.group.WORLD}
    for w, group in groups.items():
        if rank >= w:
            continue
        comm = Communicator(group, torch.device("cpu"))
        for k, dtype in enumerate(("int32", "float32", "float64", "int32x2")):
            x = exchange_global(w, dtype, seed=10 * w + k)
            slab = torch.from_numpy(x[rank * EX_ROWS:(rank + 1) * EX_ROWS].copy())
            for H in EX_HALOS:
                arrays[f"ex_{w}_{dtype}_{H}"] = comm.exchange(slab, H).numpy()


def case_laplace(rank, world, workdir, arrays):
    from devicekmc_tpu_torch.parallel import make_halo_laplace_solver, make_mesh

    data = np.load(os.path.join(workdir, "laplace.npz"))
    mesh = make_mesh(world, device="cpu")
    S = data["x0"].shape[0] // world
    sl = slice(rank * S, (rank + 1) * S)
    t = lambda name: torch.from_numpy(np.ascontiguousarray(data[name][sl]))
    solver = make_halo_laplace_solver(mesh, halo=int(data["halo"]), tol=1e-12)
    phi, iters = solver(t("edge_g"), t("neigh_idx").to(torch.int32), t("interior"),
                        t("is_left"), t("is_right"), t("x0"), float(data["v_left"]),
                        float(data["v_right"]))
    arrays["laplace_phi"] = phi.numpy()
    arrays["laplace_iters"] = np.asarray(iters)


def case_run(rank, world, workdir, arrays, facts, case):
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")
    cfg, s = run_config(os.path.join(workdir, f"halo_{case}"), RUN_CASES[case])
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh,
                     decomposition="halo")
    mesh.comm.reset_counts()
    sim.run_bias_point(RUN_VD, 1e30, max_steps=RUN_STEPS)
    for f in ("element", "charge", "potential_boundary", "potential_charge"):
        arrays[f"{case}_{f}"] = sim.global_field(f).numpy()
    facts[case] = dict(
        n_events=[r["n_events"] for r in sim.step_log], kmc_time=sim.state.kmc_time,
        halo_width=sim._halo_width, N=sim.geom.N, N_real=sim.geom.N_real,
        presolve=sim.presolve_log, counts=dict(mesh.comm.counts))


def module_config(out_dir, precision="f64"):
    """The transport module cases' configuration (local cg heat for the heat
    model) and stack."""
    return run_config(out_dir, precision=precision, **TRANSPORT, **HEAT_CASES["local"],
                      **MODULE)


def case_transport_module(rank, world, workdir, arrays, facts):
    from devicekmc_tpu_torch.parallel import halo_superstep as hs
    from devicekmc_tpu_torch.parallel import halo_transport as ht
    from devicekmc_tpu_torch.parallel import make_mesh
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.physics.events import _BLOCK
    from devicekmc_tpu_torch.physics.potential import solve_cb_edge
    from devicekmc_tpu_torch.state import build_simulation, replace

    data = np.load(os.path.join(workdir, "transport.npz"))
    mesh = make_mesh(world, device="cpu")
    for prec in ("f64", "mixed"):
        cfg, s = module_config(os.path.join(workdir, "module"), prec)
        geom, params, state = build_simulation(cfg, elements=s.elements, coords=s.coords,
                                               device="cpu", pad_to=world * _BLOCK)
        elements = data["element"]
        ts, sizes = ht.build_transport_static(geom, params, elements, mesh)
        heat = heat_mod.build_heat_model(geom, params, cfg, elements,
                                         geom.neigh_idx.numpy(), method="cg")
        halo = hs.required_halo(geom)
        n_sites = geom.N
        geom, state = hs.shard_halo_simulation(geom, state, mesh)
        heat = hs.shard_heat_model(heat, n_sites, mesh)
        S = n_sites // world
        cut = lambda name: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(data[name][rank * S:(rank + 1) * S]))
        element, charge, cb = cut("element"), cut("charge"), cut("CB_edge")
        sh = hs._Shard(mesh.comm, geom.neigh_idx, halo, geom.N_real)
        op = ht.assemble_halo_operator(sh, geom, params, ts, sizes, element, charge, cb)
        arrays[f"tm_{prec}_y"] = op["apply"](torch.from_numpy(data["x"]), params.dtype).numpy()
        arrays[f"tm_{prec}_Y"] = op["apply_mat"](torch.from_numpy(data["X"]),
                                                 params.dtype).numpy()
        arrays[f"tm_{prec}_int_needed"] = np.asarray(int(op["int_needed"]))
        if prec != "f64":
            continue
        vp, I_macro, atom_power, P_tot, m = ht.halo_transport_power(
            sh, geom, params, ts, sizes, element, charge, cb,
            torch.zeros(geom.N_atom + 2, dtype=params.dtype), MODULE_VD)
        arrays["tm_vp"] = vp.numpy()
        arrays["tm_atom_power"] = atom_power.numpy()
        facts["transport_module"] = dict(I_macro=I_macro, P_tot=P_tot, metrics=m, sizes=sizes)
        for k, step_time in enumerate(HEAT_STEP_TIMES):
            temp, T_bg, _ = ht.halo_heat_local_cg(
                sh, geom, params, heat, element, cut("power"), cut("temperature"), step_time)
            arrays[f"tm_temp_{k}"] = temp.numpy()
            facts[f"tm_T_bg_{k}"] = T_bg
            facts[f"tm_heat_{k}"] = dict(heat_mod.last_local)
        # the CB edge solved on the slabs from the initial state's
        cb_state, cb_m = solve_cb_edge(geom, params,
                                       replace(state, element=element, charge=charge),
                                       MODULE_VD, slab=sh)
        arrays["tm_cb_edge"] = cb_state.CB_edge.numpy()
        facts["tm_cb_edge_iters"] = cb_m["cg_iters_cb_edge"]


def case_transport_runs(rank, world, workdir, arrays, facts):
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")
    for case, over in HEAT_CASES.items():
        cfg, s = run_config(os.path.join(workdir, f"transport_{case}"), **TRANSPORT, **over)
        sim = Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh,
                         decomposition="halo")
        mesh.comm.reset_counts()
        sim.run_bias_point(RUN_VD, 1e30, max_steps=RUN_STEPS)
        for f in ("element", "charge", "power", "temperature"):
            arrays[f"tr_{case}_{f}"] = sim.global_field(f).numpy()
        arrays[f"tr_{case}_vp"] = sim.state.virtual_potentials.numpy()
        facts[f"tr_{case}"] = dict(
            steps=[{k: r[k] for k in ("n_events", "Current [uA]", "cg_iters_power",
                                       "transport_converged", "Total dissipated power [mW]",
                                       "Global temperature [K]")} for r in sim.step_log],
            I_macro=sim.state.I_macro, P_tot=sim.state.P_tot, T_bg=sim.state.T_bg,
            kmc_time=sim.state.kmc_time, presolve=sim.presolve_log,
            counts=dict(mesh.comm.counts))


def expect_raise(facts, name, exc, fn):
    try:
        fn()
    except exc as e:
        facts.setdefault("raises", {})[name] = f"{type(e).__name__}: {e}"
        return
    facts.setdefault("raises", {})[name] = "no exception"


def case_raises(rank, world, workdir, facts):
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")
    out = os.path.join(workdir, "raises")
    cfg, s = run_config(out, stack=WIDE_STACK)
    expect_raise(facts, "halo_width", ValueError, lambda: Simulation(
        cfg, elements=s.elements, coords=s.coords, mesh=mesh, decomposition="halo"))
    cfg, s = run_config(out, **dict(TRANSPORT, transport="dense"))
    expect_raise(facts, "transport_dense", ValueError, lambda: Simulation(
        cfg, elements=s.elements, coords=s.coords, mesh=mesh, decomposition="halo"))
    cfg, s = run_config(out, **TRANSPORT, **dict(HEAT_CASES["local"], heat_solver="dense"))
    expect_raise(facts, "heat_dense", ValueError, lambda: Simulation(
        cfg, elements=s.elements, coords=s.coords, mesh=mesh, decomposition="halo"))
    # the replicated decomposition, which raised until it was ported, now runs
    cfg, s = run_config(os.path.join(out, "replicate"))
    os.makedirs(cfg.output_dir, exist_ok=True)
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh,
                     decomposition="replicate")
    steps = sim.run_bias_point(RUN_VD, 1e30, max_steps=1)["steps"]
    facts.setdefault("raises", {})["replicate"] = (
        f"runs: decomposition={sim.decomposition!r}, {steps} superstep")
    expect_raise(facts, "world_size", ValueError, lambda: make_mesh(world - 1, device="cpu"))


def main(workdir, rank, world, cases=DEFAULT_CASES):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'rdzv')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    arrays, facts = {}, {}
    try:
        for case in cases:
            if case == "exchange":
                case_exchange(rank, world, arrays)
            elif case == "laplace":
                case_laplace(rank, world, workdir, arrays)
            elif case == "run":
                for run in RUN_CASES:
                    case_run(rank, world, workdir, arrays, facts, run)
            elif case == "raises":
                case_raises(rank, world, workdir, facts)
            elif case == "transport":
                case_transport_module(rank, world, workdir, arrays, facts)
                case_transport_runs(rank, world, workdir, arrays, facts)
            else:
                raise ValueError(f"unknown case {case!r}")
    except Exception:
        facts["error"] = traceback.format_exc()
        raise
    finally:
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(facts, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
         *([sys.argv[4].split(",")] if len(sys.argv) > 4 else []))
