"""The port's replicated decomposition (``devicekmc_tpu_torch.parallel.
sharding``, what ``Simulation(mesh=...)`` runs by default), the replica axis
over a mesh (``parallel.batched``'s ``mesh=``, ``shard_batch``,
``gather_batch``), the 2-D ``("batch", "sites")`` mesh and checkpoints under
a mesh (npz, dcp, dcp_async), on the CPU against the JAX package.

Four gloo ranks run as separate processes (``tests/torch_sharding_ranks.py``,
which imports no JAX), started once for the whole file with a file
rendezvous and a hard time limit that kills them.  While they run, this
process writes the JAX package's checkpoint that they continue and computes
the references: the JAX package's ``make_sharded_superstep``,
``Simulation(mesh=...)`` and sharded ``make_batched_superstep`` on 4 CPU
devices (along ``"batch"``, and on a (2, 2) ``("batch", "sites")`` mesh), and
the port's single device and one-process batch.  A world of
one gloo rank runs in this process.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from torch_sharding_ranks import (BATCH, BATCH_SEED, CKPT_BACKENDS, CKPT_STEPS,
                                  DRIVER_STEPS, MESH_BATCH, MESH_SHAPES, MESH_STEPS, MIXED,
                                  RESUME_FIELDS, VD, driver_config, pieces, pieces_config,
                                  pieces_elements)

torch.set_num_threads(1)

WORLD = 4
#: seconds the four ranks may take together before they are killed
RANKS_TIMEOUT = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the cases whose states every rank writes (each must be bit-equal on the ranks)
RANK_STATES = ("ss", "driver", "mixed", "batch", "jax_resumed", "m2x2", "m4x1", "m1x4",
               "b1d", "s1d")


def _to_jax(tcfg):
    from devicekmc_tpu.config import KMCConfig, Layer

    names = {g.name for g in dataclasses.fields(KMCConfig)}
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
              if f.name in names}
    fields["layers"] = [Layer(**dataclasses.asdict(l)) for l in tcfg.layers]
    return KMCConfig(**fields)


def _jax_mesh(axis="sites", shape=(WORLD,)):
    axes = (axis,) if len(shape) == 1 else ("batch", "sites")
    return JaxMesh(np.array(jax.devices("cpu")[:WORLD]).reshape(shape), axes)


def _events(output_txt):
    with open(output_txt) as f:
        return [int(float(l.split(":")[1])) for l in f if l.startswith("n_events:")]


def _np(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


# ----------------------------------------------------------------------------
# the JAX package's runs
# ----------------------------------------------------------------------------

def _jax_sim(out_dir):
    from devicekmc_tpu.engine import Simulation as JaxSimulation

    cfg, s = driver_config(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    return JaxSimulation(_to_jax(cfg), elements=s.elements, coords=s.coords, mesh=_jax_mesh())


def _jax_checkpoint_run(workdir):
    """The JAX package's 4-device replicated run of the driver
    configuration: 2 supersteps, the checkpoint the ranks continue (written
    whole, then renamed), 2 more.  Returns its events."""
    sim = _jax_sim(str(workdir / "jax_run"))
    sim.run(max_steps_per_bias=CKPT_STEPS)
    tmp = str(workdir / "jax_ckpt.tmp.npz")
    sim.save_checkpoint(tmp)
    os.replace(tmp, str(workdir / "jax_ckpt.npz"))
    sim.run(max_steps_per_bias=2 * CKPT_STEPS)
    return _events(sim.output_path)


def _jax_pieces():
    from devicekmc_tpu.physics import heat as jheat
    from devicekmc_tpu.state import build_geometry, build_params, init_state

    cfg, s = pieces_config()
    jcfg = _to_jax(cfg)
    elems = pieces_elements(s)
    geom = build_geometry(elems, s.coords, jcfg, pad_to=WORLD)
    params = build_params(jcfg)
    return geom, params, init_state(geom, jcfg, elems), jheat.empty_heat_model(params)


def _jax_superstep():
    """tests/test_sharding.py::test_sharded_matches_single's sharded run on 4
    devices."""
    from devicekmc_tpu.parallel import make_sharded_superstep, shard_simulation
    from devicekmc_tpu.parallel.sharding import solve_cb_edge_sharded

    geom, params, state, heat = _jax_pieces()
    mesh = _jax_mesh()
    geom, state = shard_simulation(geom, state, mesh)
    state, _ = solve_cb_edge_sharded(geom, params, state, VD, mesh)
    st, dt, m = make_sharded_superstep(geom, params, heat, mesh)(state, VD)
    return st, float(dt), {k: float(v) for k, v in m.items()}


def _jax_batch():
    """tests/test_batched.py::test_batched_sharded's batch of 8 over 4
    devices."""
    from devicekmc_tpu.parallel.batched import (batch_states, make_batched_superstep,
                                                shard_batch)

    geom, params, state, heat = _jax_pieces()
    mesh = _jax_mesh("batch")
    states = shard_batch(batch_states(state, BATCH, base_seed=BATCH_SEED), mesh)
    out, dts, _ = make_batched_superstep(geom, params, heat, mesh=mesh)(states, VD)
    return out, np.asarray(dts)


def _jax_mesh2d():
    """The JAX package's (2, 2) ``("batch", "sites")`` run: the geometry of
    ``shard_simulation`` (``P("sites")``), MESH_BATCH replicas sharded
    ``P("batch")``, MESH_STEPS supersteps of the batched superstep.  Returns
    the last states and each step's events and step times [steps, B]."""
    from devicekmc_tpu.parallel import shard_simulation
    from devicekmc_tpu.parallel.batched import (batch_states, make_batched_superstep,
                                                shard_batch)

    geom, params, state, heat = _jax_pieces()
    mesh = _jax_mesh(shape=(2, 2))
    geom, state = shard_simulation(geom, state, mesh)
    states = shard_batch(batch_states(state, MESH_BATCH, base_seed=BATCH_SEED), mesh)
    step = make_batched_superstep(geom, params, heat, mesh=mesh)
    events, dts = [], []
    for _ in range(MESH_STEPS):
        states, dt, m = step(states, VD)
        events.append(np.asarray(m["n_events"]))
        dts.append(np.asarray(dt))
    return states, np.stack(events), np.stack(dts)


# ----------------------------------------------------------------------------
# the port's single device
# ----------------------------------------------------------------------------

def _single_superstep():
    from devicekmc_tpu_torch.engine import make_superstep
    from devicekmc_tpu_torch.physics.potential import solve_cb_edge

    geom, params, state, heat = pieces(WORLD)
    state, _ = solve_cb_edge(geom, params, state, VD)
    return make_superstep(geom, params, heat)(state, VD)


def _single_driver(out_dir, **over):
    from devicekmc_tpu_torch.engine import Simulation

    cfg, s = driver_config(out_dir, **over)
    os.makedirs(out_dir, exist_ok=True)
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, device="cpu")
    sim.run_bias_point(VD, 1e30, max_steps=DRIVER_STEPS)
    return sim


def _single_batch():
    from devicekmc_tpu_torch.parallel import batch_states, make_batched_superstep

    geom, params, state, heat = pieces(WORLD)
    return make_batched_superstep(geom, params, heat)(
        batch_states(state, BATCH, base_seed=BATCH_SEED), VD)


# ----------------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the four ranks, compute the references while they run (the JAX
    checkpoint first: the ranks wait for it), wait for the ranks (killing
    them at the time limit) and return what everyone made."""
    import json

    workdir = tmp_path_factory.mktemp("sharding_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    helper = os.path.join(ROOT, "tests", "torch_sharding_ranks.py")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, helper, str(workdir), str(r), str(WORLD)],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + RANKS_TIMEOUT
    timed_out = False
    try:
        refs = dict(jax_events=_jax_checkpoint_run(workdir), jax_superstep=_jax_superstep(),
                    jax_batch=_jax_batch(), jax_mesh2d=_jax_mesh2d(),
                    single_superstep=_single_superstep(),
                    single_driver=_single_driver(str(workdir / "single_driver")),
                    single_mixed=_single_driver(str(workdir / "single_mixed"), **MIXED),
                    single_batch=_single_batch())
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if timed_out or any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                          + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r, p in enumerate(procs))
        pytest.fail(("ranks killed after %d s" % RANKS_TIMEOUT if timed_out
                     else "a rank failed") + "\n" + tails)
    arrays = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(WORLD)]
    facts = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return workdir, arrays, facts, refs


# ----------------------------------------------------------------------------
# the superstep
# ----------------------------------------------------------------------------

def _superstep_checks(arrays, facts, st, dt, n_events):
    """test_sharded_matches_single's tolerances."""
    a = arrays[0]
    np.testing.assert_array_equal(a["ss_element"], _np(st.element))
    np.testing.assert_array_equal(a["ss_charge"], _np(st.charge))
    np.testing.assert_allclose(a["ss_potential_boundary"], _np(st.potential_boundary),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(a["ss_I_macro"]), float(st.I_macro), rtol=1e-6)
    assert facts[0]["superstep"]["step_time"] == pytest.approx(dt, rel=1e-12)
    assert facts[0]["superstep"]["n_events"] == n_events


def test_superstep_matches_jax_sharded(runs):
    _, arrays, facts, refs = runs
    st, dt, m = refs["jax_superstep"]
    assert facts[0]["superstep"]["N"] == st.element.shape[0]
    _superstep_checks(arrays, facts, st, dt, int(m["n_events"]))


def test_superstep_matches_single_device(runs):
    _, arrays, facts, refs = runs
    st, dt, m = refs["single_superstep"]
    _superstep_checks(arrays, facts, st, dt, int(m["n_events"]))


@pytest.mark.parametrize("case", RANK_STATES)
def test_ranks_hold_the_same_bits(runs, case):
    """After every case each rank's whole state is every other rank's, bit
    for bit."""
    _, arrays, _, _ = runs
    keys = sorted(k for k in arrays[0] if k.startswith(case + "_"))
    assert keys
    for r in range(1, WORLD):
        for k in keys:
            assert arrays[r][k].tobytes() == arrays[0][k].tobytes(), (r, k)


def test_superstep_collectives(runs):
    """The superstep's collectives: all-gathers and all-reduces only (no
    halo exchange); the rows of the pair arrays a quarter of the single
    device's."""
    _, _, facts, _ = runs
    f = facts[0]["superstep"]
    assert set(f["counts"]) == {"all_gather", "all_reduce"}
    b = f["row_bytes"]
    assert (b["pair_rows"] + b["solve_rows"]) * WORLD + b["neigh_idx_rev_slot"] \
        == b["single_device"]


# ----------------------------------------------------------------------------
# the driver
# ----------------------------------------------------------------------------

def test_driver_matches_jax(runs):
    """test_simulation_with_mesh's configuration with no decomposition
    argument: the replicated decomposition, steps and events per step equal
    to the JAX package's 4-device Simulation(mesh=...)."""
    _, _, facts, refs = runs
    f = facts[0]["driver"]
    assert f["decomposition"] == "replicate" and f["steps"] == DRIVER_STEPS
    assert f["events"] == refs["jax_events"][:DRIVER_STEPS]
    assert sum(f["events"]) > 0


def test_driver_matches_single_device(runs):
    workdir, _, facts, refs = runs
    single = refs["single_driver"]
    f = facts[0]["driver"]
    assert f["events"] == [int(r["n_events"]) for r in single.step_log]
    assert f["I_macro"] == pytest.approx(single.state.I_macro, rel=1e-6)
    # no band and no persistent tunnel store under a mesh
    assert f["params"]["transport_incremental"] is False


def test_driver_output_from_rank0(runs):
    """Four ranks share one output directory: one output.txt whose events are
    the run's once (every other rank's lines would repeat its steps)."""
    workdir, _, facts, _ = runs
    for tag in ("driver", "mixed"):
        assert _events(workdir / tag / "output.txt") == facts[0][tag]["events"]
        assert os.path.isdir(workdir / tag / f"Results_{VD:.6f}")


def test_mixed_precision_events_equal(runs):
    """Mixed precision with the pair sweep's row range (its plain version):
    events equal to the single device's step for step."""
    _, _, facts, refs = runs
    single = refs["single_mixed"]
    assert facts[0]["mixed"]["events"] == [int(r["n_events"]) for r in single.step_log]
    assert facts[0]["mixed"]["params"]["poisson_compact_cap"] > 0


# ----------------------------------------------------------------------------
# the replica axis
# ----------------------------------------------------------------------------

def test_batch_replicas_bit_equal_to_one_process(runs):
    """Replica r·B/W + i of the ranks' batch is replica r·B/W + i of the
    one-process batched run, bit for bit; no collective ran inside the
    superstep."""
    _, arrays, facts, refs = runs
    out, dts, _ = refs["single_batch"]
    a = arrays[0]
    for f in dataclasses.fields(out):
        got, want = a[f"batch_{f.name}"], _np(getattr(out, f.name))
        assert got.tobytes() == want.tobytes(), f.name
    assert a["batch_step_time"].tobytes() == _np(dts).tobytes()
    assert all(fr["batch"]["counts"] == {} for fr in facts)


def test_batch_matches_jax(runs):
    """The ranks' batch against JAX's batch sharded over 4 devices, at
    tests/test_torch_ensemble.py's tolerances."""
    _, arrays, _, refs = runs
    jout, jdts = refs["jax_batch"]
    a = arrays[0]
    np.testing.assert_array_equal(a["batch_element"], np.asarray(jout.element))
    np.testing.assert_array_equal(a["batch_charge"], np.asarray(jout.charge))
    np.testing.assert_allclose(a["batch_step_time"], jdts, rtol=1e-4)
    phi = np.asarray(jout.potential_boundary)
    np.testing.assert_allclose(a["batch_potential_boundary"], phi, rtol=0,
                               atol=1e-6 * np.abs(phi).max())
    np.testing.assert_allclose(a["batch_I_macro"], np.asarray(jout.I_macro), rtol=1e-5)
    np.testing.assert_allclose(a["batch_T_bg"], np.asarray(jout.T_bg), rtol=1e-9)


def test_shard_batch_keys_and_raise(runs):
    """Each rank holds its contiguous 2 replicas with the keys
    fold_in(PRNGKey(seed), r·B/W + i); a batch that 4 ranks do not divide
    raises ValueError."""
    from devicekmc_tpu_torch import rng

    _, _, facts, _ = runs
    per = BATCH // WORLD
    base = rng.prng_key(BATCH_SEED)
    for r, f in enumerate(facts):
        assert f["batch"]["mine"] == per
        want = [list(rng.fold_in(base, r * per + i)) for i in range(per)]
        assert [[k & 0xFFFFFFFF for k in key] for key in f["batch"]["keys"]] == want
        assert f["batch"]["raises"].startswith("ValueError: 6 replicas do not split")


# ----------------------------------------------------------------------------
# checkpoints under a mesh
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("decomposition", ["replicate", "halo"])
def test_checkpoint_resume_under_mesh(runs, decomposition):
    """2 supersteps, a checkpoint, 2 more; a fresh 4-rank Simulation that
    loads the (npz) checkpoint and runs the same 2 ends in the same state
    bit for bit."""
    _, arrays, facts, _ = runs
    tag = f"ckpt_{decomposition}"
    f = facts[0][tag]
    assert f["pos"] == [[0, 2 * CKPT_STEPS]] * (1 + len(CKPT_BACKENDS))
    assert f["events_npz"] == f["events_a"][CKPT_STEPS:]
    for fld in RESUME_FIELDS:
        a, b = arrays[0][f"{tag}_a_{fld}"], arrays[0][f"{tag}_npz_{fld}"]
        assert a.tobytes() == b.tobytes(), fld


@pytest.mark.parametrize("backend", ["dcp", "dcp_async"])
@pytest.mark.parametrize("decomposition", ["replicate", "halo"])
def test_dcp_resume_under_mesh(runs, decomposition, backend):
    """The same checkpoint saved as a dcp directory (dcp_async: the write in
    the background while run A takes its next 2 supersteps): the fresh
    Simulation that loads it ends where the npz resume and the uninterrupted
    run end, bit for bit, on every rank."""
    _, arrays, facts, _ = runs
    tag = f"ckpt_{decomposition}"
    for r in range(WORLD):
        f = facts[r][tag]
        assert f[f"events_{backend}"] == f["events_npz"] == f["events_a"][CKPT_STEPS:]
        for fld in RESUME_FIELDS:
            got = arrays[r][f"{tag}_{backend}_{fld}"]
            assert got.tobytes() == arrays[r][f"{tag}_npz_{fld}"].tobytes(), (r, fld)
            assert got.tobytes() == arrays[r][f"{tag}_a_{fld}"].tobytes(), (r, fld)


@pytest.mark.parametrize("decomposition", ["replicate", "halo"])
def test_dcp_writes_no_gather(runs, decomposition):
    """A dcp save or load makes no collective of the mesh (an npz save under
    halo gathers every site field to rank 0).  Under halo each rank's file
    holds its slab of every site field, one chunk of N / W rows at its
    offset; under the replicated decomposition DCP writes one copy of each
    field."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import MetadataIndex

    from devicekmc_tpu_torch.parallel.halo_superstep import STATE_SITE_FIELDS

    workdir, arrays, facts, _ = runs
    tag = f"ckpt_{decomposition}"
    for r in range(WORLD):
        counts = facts[r][tag]["counts"]
        for backend in ("dcp", "dcp_async"):
            assert counts[f"save_{backend}"] == {} and counts[f"load_{backend}"] == {}, r
    if decomposition == "halo":
        assert counts["save_npz"]["all_gather"] == len(STATE_SITE_FIELDS)
    N = arrays[0][f"{tag}_a_element"].shape[0]
    for backend in ("dcp", "dcp_async"):
        md = dcp.FileSystemReader(str(workdir / f"{tag}_{backend}")).read_metadata()
        for fld, meta in md.state_dict_metadata.items():
            chunks = sorted(meta.chunks, key=lambda c: tuple(c.offsets))
            if decomposition == "halo" and fld in STATE_SITE_FIELDS:
                S = N // WORLD
                assert [tuple(c.offsets) for c in chunks] == [(r * S,) for r in range(WORLD)]
                assert all(tuple(c.sizes) == (S,) for c in chunks), fld
                for r, c in enumerate(chunks):
                    where = md.storage_data[MetadataIndex(fld, c.offsets)]
                    assert where.relative_path == f"__{r}_0.distcp", (fld, r)
            else:
                assert len(chunks) == 1, fld


def test_jax_checkpoint_continues_in_port(runs):
    """The JAX package's 4-device replicated run's npz, loaded by 4 ranks:
    the next 2 supersteps fire the events JAX's own run fired."""
    _, _, facts, refs = runs
    got = facts[0]["jax_resumed"]
    assert got["pos"] == [0, 2 * CKPT_STEPS]
    assert got["events"] == refs["jax_events"][CKPT_STEPS:]


def test_port_checkpoint_continues_in_jax(runs):
    """The 4 ranks' npz, loaded by the JAX package's 4-device replicated
    run: the next 2 supersteps fire the events the ranks fired."""
    workdir, _, facts, _ = runs
    sim = _jax_sim(str(workdir / "jax_from_port"))
    sim.load_checkpoint(str(workdir / "port_ckpt.npz"))
    sim.run(max_steps_per_bias=2 * CKPT_STEPS)
    assert _events(sim.output_path) == facts[0]["port_run"]["events"][CKPT_STEPS:]


# ----------------------------------------------------------------------------
# one rank, and the pair sweep's row range
# ----------------------------------------------------------------------------

#: the resolved options both runs share: the dense path, mixed precision
#: with the pair sweep and compacted rows, and blocked transport (no band, no
#: persistent tunnel store)
WORLD1 = {"f64": {}, "mixed": MIXED,
          "blocked": dict(precision="mixed", transport="blocked", transport_banded=False,
                          transport_incremental="off")}


def test_world1_bit_equal_to_single_device(tmp_path):
    """A world of one gloo rank in this process: the replicated
    decomposition's run is the single device's eager run with the same
    resolved options, every field bit for bit."""
    import torch.distributed as dist

    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        for tag, over in WORLD1.items():
            sims = []
            for m in (None, mesh):
                cfg, s = driver_config(tmp_path / f"{tag}_{m is None}", **over)
                os.makedirs(cfg.output_dir)
                sim = Simulation(cfg, elements=s.elements, coords=s.coords, device="cpu",
                                 mesh=m)
                if m is None:
                    sim._make = engine.make_superstep
                sim.run_bias_point(VD, 1e30, max_steps=DRIVER_STEPS)
                sims.append(sim)
            single, rep = sims
            assert rep.decomposition == "replicate" and rep._band is None
            assert single.params == rep.params, tag
            for f in dataclasses.fields(single.state):
                a, b = getattr(single.state, f.name), getattr(rep.state, f.name)
                if torch.is_tensor(a):
                    assert a.dtype == b.dtype and torch.equal(a, b), (tag, f.name)
                else:
                    assert a == b or (a != a and b != b), (tag, f.name)
            assert [r["n_events"] for r in single.step_log] == \
                [r["n_events"] for r in rep.step_log]
    finally:
        dist.destroy_process_group()


def test_mesh_axes():
    """A 2-D ("batch", "sites") mesh builds (a world of one gloo rank in this
    process), each axis a 1-D view of itself, a 1-D mesh's view of its axis
    itself; a shape whose product is not the world size, an unknown or a
    repeated axis raises ValueError, and so does a Simulation on a 2-D mesh."""
    import torch.distributed as dist

    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel.mesh import Mesh, make_mesh

    with pytest.raises(ValueError, match="unknown mesh axis"):
        Mesh(None, torch.device("cpu"), ("rows",))
    with pytest.raises(ValueError, match="distinct"):
        Mesh(None, torch.device("cpu"), ("sites", "sites"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu", axis_names=("batch", "sites"), shape=(1, 1))
        assert mesh.shape == (1, 1)
        for name in ("batch", "sites"):
            view = mesh.axis(name)
            assert view.axis_names == (name,) and view.world == 1 and view.axis(name) is view
        one = make_mesh(1, device="cpu")
        assert one.axis("sites") is one and one.shape == (1,)
        with pytest.raises(ValueError, match="along 'batch'"):
            one.axis("batch")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(1, device="cpu", axis_names=("batch", "sites"), shape=(2, 1))
        with pytest.raises(ValueError, match="unknown mesh axis"):
            make_mesh(1, device="cpu", axis_names=("batch", "rows"))
        cfg, s = driver_config("unused")
        with pytest.raises(ValueError, match="1-D mesh"):
            Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# the 2-D ("batch", "sites") mesh
# ----------------------------------------------------------------------------

def test_mesh2d_matches_jax(runs):
    """The (2, 2) mesh's batch against the JAX package's (2, 2) run: events
    step for step, elements and charges equal; potentials, step times,
    I_macro and T_bg within test_batch_matches_jax's tolerances."""
    _, arrays, _, refs = runs
    jout, jev, jdts = refs["jax_mesh2d"]
    a = arrays[0]
    np.testing.assert_array_equal(a["m2x2_events"], jev.astype(np.float64))
    np.testing.assert_array_equal(a["m2x2_element"], np.asarray(jout.element))
    np.testing.assert_array_equal(a["m2x2_charge"], np.asarray(jout.charge))
    np.testing.assert_allclose(a["m2x2_dts"], jdts, rtol=1e-4)
    phi = np.asarray(jout.potential_boundary)
    np.testing.assert_allclose(a["m2x2_potential_boundary"], phi, rtol=0,
                               atol=1e-6 * np.abs(phi).max())
    np.testing.assert_allclose(a["m2x2_I_macro"], np.asarray(jout.I_macro), rtol=1e-5)
    np.testing.assert_allclose(a["m2x2_T_bg"], np.asarray(jout.T_bg), rtol=1e-9)


@pytest.mark.parametrize("mesh2d,mesh1d", [("m4x1", "b1d"), ("m1x4", "s1d")],
                         ids=["4x1-batch", "1x4-sites"])
def test_mesh2d_bit_equal_to_1d(runs, mesh2d, mesh1d):
    """(4, 1) is the 1-D "batch" run of the same replicas, and (1, 4) each
    replica's 1-D "sites" run, every field, event count and step time bit
    for bit."""
    _, arrays, _, _ = runs
    a = arrays[0]
    keys = sorted(k[len(mesh1d) + 1:] for k in a if k.startswith(mesh1d + "_"))
    assert len(keys) > 10
    for k in keys:
        got, want = a[f"{mesh2d}_{k}"], a[f"{mesh1d}_{k}"]
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k


def test_mesh2d_layout(runs):
    """Rank r sits at (r // S, r % S) of each (B, S) mesh, holds MESH_BATCH /
    B replicas and N / S rows of the pair arrays; the ranks of one "sites"
    line hold the same replicas bit for bit; the 2-D mesh's own group runs
    no collective (each replica's run is its "sites" line's)."""
    _, arrays, facts, _ = runs
    N = arrays[0]["m2x2_element"].shape[1]
    for B, S in MESH_SHAPES:
        tag = f"m{B}x{S}"
        for r in range(WORLD):
            f = facts[r]["mesh2d"][tag]
            assert f["coords"] == [r // S, r % S]
            assert f["mine"] == MESH_BATCH // B and f["rows"] == N // S
            assert f["sites_line"] == [(r // S) * S + k for k in range(S)]
            assert f["counts"] == {} and set(f["sites_counts"]) == {"all_gather", "all_reduce"}
            for k in (k for k in arrays[r] if k.startswith(f"loc{tag}_")):
                line0 = (r // S) * S
                assert arrays[r][k].tobytes() == arrays[line0][k].tobytes(), (tag, r, k)


@pytest.mark.parametrize("pbc", [False, True])
def test_pair_sweep_row_range_plain(pbc):
    """The pair sweep's plain version over a row range is the whole sweep's
    rows bit for bit (the kernel's contract for a row range)."""
    from devicekmc_tpu_torch.ops.pairwise import (kernel_scalars, poisson_pairwise_plain,
                                                  poisson_pairwise_rows)

    rng = np.random.default_rng(5)
    n = 3001
    coords = torch.tensor(rng.uniform(0.0, 30.0, (n, 3)), dtype=torch.float32)
    cidx = torch.tensor(np.sort(rng.choice(n, 211, replace=False)), dtype=torch.int32)
    cq = torch.tensor(rng.choice([-2.0, 2.0], 211), dtype=torch.float32)
    sc = kernel_scalars(3.5e-10, 8.9875e9 / 25.0, [30.0, 30.0, 30.0], torch.float64)
    whole = poisson_pairwise_plain(coords, cidx, cq, *sc, pbc)
    for row0, n_rows in ((0, n), (0, 750), (750, 750), (1500, 1501), (2999, 2), (5, 0)):
        part = poisson_pairwise_rows(coords, row0, n_rows, cidx, cq, *sc, pbc)
        assert torch.equal(part, whole[row0:row0 + n_rows])
