"""One rank of the replicated decomposition's CPU tests (tests/test_torch_sharding.py).

    python tests/torch_sharding_ranks.py WORKDIR RANK WORLD [CASES]

Joins a gloo group of WORLD ranks through a file rendezvous in WORKDIR, runs
the cases below and writes what it saw to ``WORKDIR/rank<RANK>.npz``
(arrays) and ``WORKDIR/rank<RANK>.json`` (counts, events, messages).  Imports
no JAX: the test process holds the results against the JAX package.

Cases (CASES: comma-separated names, default all, in this order):
  * ``superstep``: the stack of tests/test_sharding.py (8 vacancies, dense
    transport, global heat), padded to WORLD sites: the CB edge
    (``solve_cb_edge_sharded``) and one superstep of
    ``make_sharded_superstep`` at 2 V; every field of the state afterwards;
  * ``driver``: ``Simulation(cfg, mesh=...)`` without a ``decomposition``
    on tests/test_sharding.py::test_simulation_with_mesh's configuration, 3
    supersteps at 2 V, every rank writing into one output directory; and
    the same in mixed precision with the pair-sweep kernel's plain version
    and compacted event rows;
  * ``batch``: the replica axis over a ``("batch",)`` mesh: 8 replicas of
    the superstep case's state (``batch_states(..., base_seed=3)``), this
    rank's 2 through one batched superstep, gathered whole; a batch of 6
    must raise;
  * ``ckpt``: under each decomposition, 2 supersteps, a checkpoint in each
    backend (npz, dcp, dcp_async; the Communicator's counts of each save),
    2 more (before the wait for the dcp_async write); then for each backend a
    fresh Simulation loads its checkpoint and runs the same 2;
  * ``jax_ckpt``: ``WORKDIR/jax_ckpt.npz``, written by the JAX package's
    4-device replicated run of the driver configuration after 2 supersteps
    (waited for), loaded and run for 2 more; and the driver configuration's
    own checkpoint after 2 supersteps (``port_ckpt.npz``), for the JAX
    package to continue;
  * ``mesh2d``: the ``("batch", "sites")`` mesh in the shapes of MESH_SHAPES:
    MESH_BATCH replicas of the superstep case's state (no CB edge),
    MESH_STEPS supersteps through ``make_batched_superstep`` on the geometry
    of ``shard_simulation``, the batch gathered whole; beside it the 1-D
    runs it must equal: the same replicas over a ``("batch",)`` mesh, and
    each replica alone over a ``("sites",)`` mesh.
"""

import dataclasses
import datetime
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: the bias of every case, and its supersteps
VD = 2.0
DRIVER_STEPS = 3
#: supersteps before a checkpoint, and after it
CKPT_STEPS = 2
#: replicas of the batch case, and a count that 4 ranks do not divide
BATCH = 8
BATCH_SEED = 3
BAD_BATCH = 6
#: the mixed-precision driver's settings beside the configuration's
MIXED = dict(precision="mixed", poisson_kernel="pallas", poisson_compact_cap=-1,
             active_rows_cap=64)
#: seconds a rank waits for the JAX package's checkpoint
JAX_CKPT_WAIT = 240
#: the backends of the checkpoint case, each saved at the same step
CKPT_BACKENDS = {"npz": "npz", "dcp": "dcp", "dcp_async": "dcp_async"}
#: the 2-D meshes (batch x sites), their replicas and supersteps
MESH_SHAPES = ((2, 2), (4, 1), (1, 4))
MESH_BATCH = 4
MESH_STEPS = 2
#: the fields a resume must reproduce bit for bit
RESUME_FIELDS = ("element", "charge", "key", "kmc_time", "I_macro", "virtual_potentials",
                 "CB_edge")


def pieces_config(out_dir="unused", **over):
    """tests/test_sharding.py's ``sim_pieces`` configuration in the port."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=6, ny=3, nz=3, seed=3)
    base = dict(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact, num_atoms_contact=s.num_atoms_contact,
        layers=s.layers, solve_potential=True, solve_current=True,
        solve_heating_global=True, perturb_structure=True, A=6.25e-19,
        output_dir=str(out_dir))
    base.update(over)
    return KMCConfig(**base), s


def pieces_elements(s):
    """The stack's elements with tests/test_sharding.py's 8 vacancies."""
    from devicekmc_tpu_torch.structure import Element

    elems = s.elements.copy()
    rng = np.random.default_rng(7)
    oxide = np.nonzero(elems == int(Element.O))[0]
    elems[rng.choice(oxide, size=8, replace=False)] = int(Element.VACANCY)
    return elems


def pieces(world, device="cpu"):
    """The port's (geometry, params, state, heat) of ``sim_pieces``, padded to
    ``world`` sites."""
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import build_geometry, build_params, init_state

    cfg, s = pieces_config()
    elems = pieces_elements(s)
    geom = build_geometry(elems, s.coords, cfg, device=device, pad_to=world)
    params = build_params(cfg)
    state = init_state(geom, cfg, elems)
    return geom, params, state, heat_mod.empty_heat_model(params, device)


def driver_config(out_dir, **over):
    """tests/test_sharding.py::test_simulation_with_mesh's configuration:
    the stack with 10 % vacancies, dense transport, global heat; one bias
    point at VD that the step count ends."""
    return pieces_config(out_dir, pristine=True, initial_vacancy_concentration=0.1,
                         V_switch=[VD], t_switch=[1e30], log_freq=1000, **over)


def halo_config(out_dir):
    """The stack of tests/torch_halo_ranks.py's ``run`` case (the halo path's
    test stack), without transport."""
    from torch_halo_ranks import run_config

    return run_config(out_dir, V_switch=[VD], t_switch=[1e30])


def state_arrays(state, prefix, arrays):
    """Every field of ``state`` into ``arrays`` (the key as uint32[2], the
    host scalars as f64)."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if torch.is_tensor(v):
            arrays[f"{prefix}_{f.name}"] = v.cpu().numpy()
        elif f.name == "key":
            arrays[f"{prefix}_{f.name}"] = np.asarray(v, dtype=np.uint32)
        else:
            arrays[f"{prefix}_{f.name}"] = np.asarray(v, dtype=np.float64)


def case_superstep(rank, world, arrays, facts):
    from devicekmc_tpu_torch.parallel import make_mesh
    from devicekmc_tpu_torch.parallel.sharding import (make_sharded_superstep, row_bytes,
                                                       shard_simulation, solve_cb_edge_sharded)

    mesh = make_mesh(world, device="cpu")
    geom, params, state, heat = pieces(world)
    geom, state = shard_simulation(geom, state, mesh)
    state, m_cb = solve_cb_edge_sharded(geom, params, state, VD, mesh)
    step = make_sharded_superstep(geom, params, heat, mesh)
    mesh.comm.reset_counts()
    state, dt, m = step(state, VD)
    state_arrays(state, "ss", arrays)
    facts["superstep"] = dict(step_time=dt, n_events=int(m["n_events"]),
                              cg_iters_cb_edge=int(m_cb["cg_iters_cb_edge"]),
                              metrics={k: float(v) for k, v in m.items()},
                              counts=dict(mesh.comm.counts), row_bytes=row_bytes(geom, world),
                              N=geom.N)


def _events(sim):
    return [int(r["n_events"]) for r in sim.step_log]


def case_driver(rank, world, workdir, arrays, facts):
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")
    for tag, over in (("driver", {}), ("mixed", MIXED)):
        cfg, s = driver_config(os.path.join(workdir, tag), **over)
        os.makedirs(cfg.output_dir, exist_ok=True)
        sim = Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh)
        summary = sim.run_bias_point(VD, 1e30, max_steps=DRIVER_STEPS)
        state_arrays(sim.state, tag, arrays)
        facts[tag] = dict(steps=summary["steps"], events=_events(sim),
                          decomposition=sim.decomposition, N=sim.geom.N,
                          I_macro=sim.state.I_macro, presolve=sim.presolve_log,
                          params={k: getattr(sim.params, k) for k in (
                              "transport_incremental", "poisson_compact_cap",
                              "active_rows_cap")})


def case_batch(rank, world, arrays, facts):
    from devicekmc_tpu_torch.parallel import (batch_states, gather_batch,
                                              make_batched_superstep, make_mesh, shard_batch)

    mesh = make_mesh(world, device="cpu", axis_names=("batch",))
    geom, params, state, heat = pieces(world)
    mine = shard_batch(batch_states(state, BATCH, base_seed=BATCH_SEED), mesh)
    step = make_batched_superstep(geom, params, heat, mesh=mesh)
    mesh.comm.reset_counts()
    out, dts, _ = step(mine, VD)
    facts["batch"] = dict(mine=int(mine.element.shape[0]), counts=dict(mesh.comm.counts),
                          keys=mine.key.to(torch.int64).tolist())
    whole = gather_batch(out, mesh)
    state_arrays(whole, "batch", arrays)
    arrays["batch_step_time"] = mesh.comm.all_gather(dts).numpy()
    try:
        shard_batch(batch_states(state, BAD_BATCH), mesh)
        facts["batch"]["raises"] = "no exception"
    except ValueError as e:
        facts["batch"]["raises"] = f"ValueError: {e}"


def _ckpt_path(workdir, tag, backend):
    return os.path.join(workdir, f"{tag}.npz" if backend == "npz" else f"{tag}_{backend}")


def _resume_runs(make, mesh, workdir, tag, facts):
    """2 supersteps, a checkpoint in each backend, 2 more (A: run() waits for
    the dcp_async write at its end); for each backend a fresh Simulation
    that loads its checkpoint and runs the same 2.  The Communicator's
    counts of each save and load go to ``facts``.  Returns A and the
    resumed runs by backend."""
    a = make(os.path.join(workdir, f"{tag}_a"))
    a.run(max_steps_per_bias=CKPT_STEPS)
    counts = facts.setdefault(tag, {}).setdefault("counts", {})
    for backend in CKPT_BACKENDS:
        mesh.comm.reset_counts()
        a.save_checkpoint(_ckpt_path(workdir, tag, backend), backend=backend)
        counts[f"save_{backend}"] = dict(mesh.comm.counts)
    a.run(max_steps_per_bias=2 * CKPT_STEPS)
    resumed = {}
    for backend in CKPT_BACKENDS:
        b = make(os.path.join(workdir, f"{tag}_b_{backend}"))
        mesh.comm.reset_counts()
        b.load_checkpoint(_ckpt_path(workdir, tag, backend), backend=backend)
        counts[f"load_{backend}"] = dict(mesh.comm.counts)
        b.run(max_steps_per_bias=2 * CKPT_STEPS)
        resumed[backend] = b
    return a, resumed


def case_ckpt(rank, world, workdir, arrays, facts):
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")

    def make(config, decomposition):
        def build(out):
            cfg, s = config(out)
            os.makedirs(out, exist_ok=True)
            return Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh,
                              decomposition=decomposition)
        return build

    for tag, config, dec in (("ckpt_replicate", driver_config, "replicate"),
                             ("ckpt_halo", halo_config, "halo")):
        a, resumed = _resume_runs(make(config, dec), mesh, workdir, tag, facts)
        for k, sim in (("a", a), *resumed.items()):
            for f in RESUME_FIELDS:
                v = getattr(sim.state, f) if dec == "replicate" or f not in (
                    "element", "charge", "CB_edge") else sim.global_field(f)
                arrays[f"{tag}_{k}_{f}"] = (v.cpu().numpy() if torch.is_tensor(v)
                                            else np.asarray(v, dtype=np.float64 if f != "key"
                                                            else np.uint32))
        facts[tag].update(events_a=_events(a), pos=[a._pos] + [b._pos for b in resumed.values()],
                          **{f"events_{k}": _events(b) for k, b in resumed.items()})


def case_jax_ckpt(rank, world, workdir, arrays, facts):
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")
    # the port's run of the driver configuration, its checkpoint for JAX
    cfg, s = driver_config(os.path.join(workdir, "port_run"))
    os.makedirs(cfg.output_dir, exist_ok=True)
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh)
    sim.run(max_steps_per_bias=CKPT_STEPS)
    sim.save_checkpoint(os.path.join(workdir, "port_ckpt.npz"))
    sim.run(max_steps_per_bias=2 * CKPT_STEPS)
    facts["port_run"] = dict(events=_events(sim))
    # the JAX package's checkpoint, continued here
    path = os.path.join(workdir, "jax_ckpt.npz")
    deadline = time.monotonic() + JAX_CKPT_WAIT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {JAX_CKPT_WAIT} s")
        time.sleep(0.2)
    cfg, s = driver_config(os.path.join(workdir, "jax_resumed"))
    os.makedirs(cfg.output_dir, exist_ok=True)
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh)
    sim.load_checkpoint(path)
    sim.run(max_steps_per_bias=2 * CKPT_STEPS)
    facts["jax_resumed"] = dict(events=_events(sim), pos=sim._pos)
    state_arrays(sim.state, "jax_resumed", arrays)


def _run_batch(step, states, arrays, prefix, gather=None):
    """MESH_STEPS supersteps of ``step`` from ``states``; the events and step
    times of every step (gathered whole with ``gather``) and the last
    states into ``arrays`` under ``prefix``."""
    events, dts = [], []
    for _ in range(MESH_STEPS):
        states, dt, m = step(states, VD)
        ev = m["n_events"].to(torch.float64)
        events.append(gather(ev) if gather else ev)
        dts.append(gather(dt) if gather else dt)
    arrays[f"{prefix}_events"] = torch.stack(events).numpy()
    arrays[f"{prefix}_dts"] = torch.stack(dts).numpy()
    return states


def case_mesh2d(rank, world, arrays, facts):
    from devicekmc_tpu_torch.parallel import (batch_states, gather_batch,
                                              make_batched_superstep, make_mesh, shard_batch)
    from devicekmc_tpu_torch.parallel.sharding import make_sharded_superstep, shard_simulation
    from devicekmc_tpu_torch.state import stack_states, unbatch_all

    geom, params, state, heat = pieces(world)
    states0 = batch_states(state, MESH_BATCH, base_seed=BATCH_SEED)
    out = facts["mesh2d"] = {}
    for shape in MESH_SHAPES:
        tag = f"m{shape[0]}x{shape[1]}"
        mesh = make_mesh(world, device="cpu", axis_names=("batch", "sites"), shape=shape)
        g, _ = shard_simulation(geom, state, mesh)
        step = make_batched_superstep(g, params, heat, mesh=mesh)
        mine = shard_batch(states0, mesh)
        bcomm = mesh.axis("batch").comm
        mesh.comm.reset_counts()
        last = _run_batch(step, mine, arrays, tag, gather=bcomm.all_gather)
        state_arrays(last, f"loc{tag}", arrays)
        state_arrays(gather_batch(last, mesh), tag, arrays)
        out[tag] = dict(coords=[mesh.axis("batch").rank, mesh.axis("sites").rank],
                        mine=int(mine.element.shape[0]),
                        sites_line=[l for l in mesh.axis("sites").lines if rank in l][0],
                        rows=int(g.neigh_valid.shape[0]), counts=dict(mesh.comm.counts),
                        sites_counts=dict(mesh.axis("sites").comm.counts))
    # the 1-D runs: the replicas over a ("batch",) mesh, each replica alone
    # over a ("sites",) mesh
    mesh_b = make_mesh(world, device="cpu", axis_names=("batch",))
    last = _run_batch(make_batched_superstep(geom, params, heat, mesh=mesh_b),
                      shard_batch(states0, mesh_b), arrays, "b1d", gather=mesh_b.comm.all_gather)
    state_arrays(gather_batch(last, mesh_b), "b1d", arrays)
    mesh_s = make_mesh(world, device="cpu")
    g, _ = shard_simulation(geom, state, mesh_s)
    single = make_sharded_superstep(g, params, heat, mesh_s)
    ends, events, dts = [], [], []
    for st in unbatch_all(states0):
        ev, dt = [], []
        for _ in range(MESH_STEPS):
            st, t, m = single(st, VD)
            ev.append(float(m["n_events"]))
            dt.append(float(t))
        ends.append(st)
        events.append(ev)
        dts.append(dt)
    arrays["s1d_events"] = np.asarray(events).T
    arrays["s1d_dts"] = np.asarray(dts).T
    state_arrays(stack_states(ends), "s1d", arrays)


CASES = {"superstep": case_superstep, "driver": case_driver, "batch": case_batch,
         "ckpt": case_ckpt, "jax_ckpt": case_jax_ckpt, "mesh2d": case_mesh2d}
#: the arguments of each case beyond (rank, world)
_ARGS = {"superstep": ("arrays", "facts"), "batch": ("arrays", "facts"),
         "mesh2d": ("arrays", "facts")}


def main(workdir, rank, world, cases=tuple(CASES)):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'rdzv')}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    arrays, facts = {}, {}
    try:
        for case in cases:
            kw = dict(workdir=workdir, arrays=arrays, facts=facts)
            CASES[case](rank, world, *(kw[a] for a in _ARGS.get(
                case, ("workdir", "arrays", "facts"))))
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
