"""The port's halo decomposition (``devicekmc_tpu_torch.parallel``: mesh,
multihost, halo, halo_superstep) on the CPU, against the JAX package.

Four gloo ranks run as separate processes (``tests/torch_halo_ranks.py``,
which imports no JAX), started once for the whole file with a file
rendezvous and a hard time limit that kills them: a hung collective fails
the tests instead of holding the suite.  They run the halo exchange in
groups of 1, 2 and 4 ranks, the distributed Laplace solve and a halo
simulation of the stack of tests/test_halo_superstep.py; this process holds
what they wrote against the JAX package (its halo solver and halo run on 4
CPU devices) and against the port's single-device run.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from torch_halo_ranks import (EX_HALOS, EX_ROWS, RUN_CASES, RUN_STEPS, RUN_VD,
                              exchange_global, run_config)

torch.set_num_threads(1)

WORLD = 4
#: seconds the four ranks may take together before they are killed
RANKS_TIMEOUT = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------------------
# the JAX side
# ----------------------------------------------------------------------------

def _laplace_inputs():
    """The inputs of tests/test_halo.py's halo Laplace test (the 304-site
    stack with 10 vacancies, padded to 4 slabs, Jacobi) and the JAX
    package's 4-device halo solve of them at tol 1e-12."""
    from devicekmc_tpu.config import KMCConfig
    from devicekmc_tpu.parallel.halo import compute_halo_width, make_halo_laplace_solver
    from devicekmc_tpu.physics import charge as charge_mod
    from devicekmc_tpu.physics.potential import _edge_conductance_boundary
    from devicekmc_tpu.state import build_geometry, build_params, init_state
    from devicekmc_tpu.structure import Element, make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=10, ny=4, nz=4, seed=2)
    elems = s.elements.copy()
    rng = np.random.default_rng(3)
    oxide = np.nonzero(elems == int(Element.O))[0]
    elems[rng.choice(oxide, 10, replace=False)] = int(Element.VACANCY)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers, solve_potential=True,
    )
    geom = build_geometry(elems, s.coords, cfg, pad_to=WORLD)
    params = build_params(cfg).replace(boundary_precond="jacobi")
    state = init_state(geom, cfg, elems)
    state, _ = charge_mod.update_charge(geom, state)
    Vd = 2.0
    halo = compute_halo_width(np.asarray(geom.neigh_idx))
    assert halo <= geom.N // WORLD
    edge_g = _edge_conductance_boundary(geom, state, params)
    mesh = JaxMesh(np.array(jax.devices("cpu")[:WORLD]), ("sites",))
    solver = make_halo_laplace_solver(mesh, halo=halo, tol=1e-12)
    with mesh:
        phi, iters = solver(
            edge_g, geom.neigh_idx, geom.interior_mask, geom.left_mask, geom.right_mask,
            state.potential_boundary, jnp.asarray(-Vd / 2, params.dtype),
            jnp.asarray(Vd / 2, params.dtype))
    inputs = dict(
        edge_g=np.asarray(edge_g), neigh_idx=np.asarray(geom.neigh_idx),
        interior=np.asarray(geom.interior_mask), is_left=np.asarray(geom.left_mask),
        is_right=np.asarray(geom.right_mask), x0=np.asarray(state.potential_boundary),
        v_left=np.float64(-Vd / 2), v_right=np.float64(Vd / 2), halo=np.int64(halo))
    return inputs, np.asarray(phi), int(iters)


def _jax_config(out_dir, barrier_scale=1.0):
    from devicekmc_tpu.config import KMCConfig, Layer

    tcfg, s = run_config(out_dir, barrier_scale)
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
              if f.name in {g.name for g in dataclasses.fields(KMCConfig)}}
    fields["layers"] = [Layer(**dataclasses.asdict(l)) for l in tcfg.layers]
    return KMCConfig(**fields), s


def _events(output_txt):
    with open(output_txt) as f:
        return [float(l.split(":")[1]) for l in f if l.startswith("n_events:")]


# ----------------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def laplace():
    return _laplace_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, laplace):
    """Start the four ranks once, wait for them (killing them at the time
    limit), and return what each wrote."""
    workdir = tmp_path_factory.mktemp("halo_ranks")
    np.savez(workdir / "laplace.npz", **laplace[0])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    helper = os.path.join(ROOT, "tests", "torch_halo_ranks.py")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, helper, str(workdir), str(r), str(WORLD)],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + RANKS_TIMEOUT
    timed_out = False
    try:
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
    return workdir, arrays, facts


# ----------------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------------

def test_compute_halo_width_matches_jax(laplace):
    from devicekmc_tpu.parallel.halo import compute_halo_width as jax_width
    from devicekmc_tpu.parallel.halo_superstep import required_halo as jax_required
    from devicekmc_tpu.state import build_geometry as jax_geometry
    from devicekmc_tpu_torch.parallel.halo import compute_halo_width
    from devicekmc_tpu_torch.parallel.halo_superstep import required_halo
    from devicekmc_tpu_torch.state import build_geometry

    nb = laplace[0]["neigh_idx"]
    assert compute_halo_width(nb) == jax_width(nb) == int(laplace[0]["halo"])
    assert compute_halo_width(torch.tensor(nb)) == jax_width(nb)
    tcfg, s = run_config("unused")
    jcfg, js = _jax_config("unused")
    np.testing.assert_array_equal(s.elements, js.elements)
    np.testing.assert_array_equal(s.coords, js.coords)
    pad = WORLD * 128
    tg = build_geometry(s.elements, s.coords, tcfg, device="cpu", pad_to=pad)
    jg = jax_geometry(js.elements, js.coords, jcfg, pad_to=pad)
    np.testing.assert_array_equal(tg.neigh_idx.numpy(), np.asarray(jg.neigh_idx))
    assert (tg.N, tg.N_real) == (jg.N, jg.N_real)
    assert required_halo(tg) == jax_required(jg) <= tg.N // WORLD


@pytest.mark.parametrize("dtype", ["int32", "float32", "float64", "int32x2"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_exchange_bit_equal(ranks, world, dtype):
    """Each rank's window is the global vector's slice around its slab, with
    zeros past the domain's edges, bit for bit, at halo widths 0, 3 and S."""
    _, arrays, _ = ranks
    x = exchange_global(world, dtype, seed=10 * world + ["int32", "float32", "float64",
                                                         "int32x2"].index(dtype))
    pad = np.zeros((max(EX_HALOS),) + x.shape[1:], x.dtype)
    xp = np.concatenate([pad, x, pad])
    for r in range(world):
        for H in EX_HALOS:
            got = arrays[r][f"ex_{world}_{dtype}_{H}"]
            lo = max(EX_HALOS) + r * EX_ROWS - H
            want = xp[lo:lo + EX_ROWS + 2 * H]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (r, H)


def test_halo_laplace_matches_jax(ranks, laplace):
    _, arrays, _ = ranks
    _, jax_phi, jax_iters = laplace
    phi = np.concatenate([a["laplace_phi"] for a in arrays])
    iters = {int(a["laplace_iters"]) for a in arrays}
    assert len(iters) == 1, "every rank reports the same iteration count"
    assert abs(iters.pop() - jax_iters) <= 1
    assert jax_iters > 0
    np.testing.assert_allclose(phi, jax_phi, rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """For each run case: the JAX package's halo run on 4 CPU devices and
    the port's single-device CPU run of the ranks' configuration."""
    from devicekmc_tpu.engine import Simulation as JaxSimulation
    from devicekmc_tpu_torch.engine import Simulation

    d = tmp_path_factory.mktemp("halo_refs")
    jmesh = JaxMesh(np.array(jax.devices("cpu")[:WORLD]), ("sites",))
    refs = {}
    for case, scale in RUN_CASES.items():
        jcfg, s = _jax_config(str(d / f"jax_{case}"), scale)
        os.makedirs(jcfg.output_dir)
        jsim = JaxSimulation(jcfg, elements=s.elements, coords=s.coords, mesh=jmesh,
                             decomposition="halo")
        jsim.run_bias_point(RUN_VD, 1e30, max_steps=RUN_STEPS)
        tcfg, s = run_config(d / f"single_{case}", scale)
        os.makedirs(tcfg.output_dir)
        tsim = Simulation(tcfg, elements=s.elements, coords=s.coords, device="cpu")
        tsim.run_bias_point(RUN_VD, 1e30, max_steps=RUN_STEPS)
        refs[case] = jsim, tsim
    return refs


def _run_fields(ranks, case, nr):
    _, arrays, facts = ranks
    a = arrays[0]
    return ({f: a[f"{case}_{f}"][:nr] for f in ("element", "charge", "potential_boundary")},
            facts[0][case])


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_halo_run_matches_jax_halo(ranks, references, case):
    jsim, _ = references[case]
    nr = jsim.geom.N_real
    fields, run = _run_fields(ranks, case, nr)
    assert run["N"] == jsim.geom.N and run["halo_width"] == jsim._halo_width
    np.testing.assert_array_equal(fields["element"], np.asarray(jsim.state.element)[:nr])
    np.testing.assert_array_equal(fields["charge"], np.asarray(jsim.state.charge)[:nr])
    p = np.asarray(jsim.state.potential_boundary)[:nr]
    assert np.abs(fields["potential_boundary"] - p).max() < 1e-8
    assert run["kmc_time"] == pytest.approx(float(jsim.state.kmc_time), rel=1e-6)
    jax_events = _events(jsim.output_path)
    assert len(jax_events) == RUN_STEPS
    assert run["n_events"] == jax_events


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_halo_run_matches_single_device(ranks, references, case):
    _, tsim = references[case]
    nr = tsim.geom.N_real
    fields, run = _run_fields(ranks, case, nr)
    np.testing.assert_array_equal(fields["element"], tsim.state.element.numpy())
    np.testing.assert_array_equal(fields["charge"], tsim.state.charge.numpy())
    assert np.abs(fields["potential_boundary"]
                  - tsim.state.potential_boundary.numpy()).max() < 1e-8
    assert run["kmc_time"] == pytest.approx(tsim.state.kmc_time, rel=1e-6)
    assert run["n_events"] == [r["n_events"] for r in tsim.step_log]
    assert len(run["n_events"]) == RUN_STEPS
    assert sum(run["n_events"]) >= (50 if case == "fast" else RUN_STEPS)


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_halo_run_output_from_rank0(ranks, references, case):
    """One output.txt (written by rank 0 alone: every other rank's lines
    would repeat its steps) with the single-device run's event lines, and
    the snapshots of the whole structure."""
    workdir, _, facts = ranks
    _, tsim = references[case]
    out = workdir / f"halo_{case}"
    assert _events(out / "output.txt") == _events(tsim.output_path)
    single = os.path.join(tsim.cfg.output_dir, f"Results_{RUN_VD:.6f}")
    folder = out / f"Results_{RUN_VD:.6f}"
    snaps = sorted(os.listdir(folder))
    assert snaps == sorted(os.listdir(single)) and snaps
    for name in snaps:
        got = (folder / name).read_text().splitlines()
        want = open(os.path.join(single, name)).read().splitlines()
        assert len(got) == len(want) == tsim.geom.N_real + 2
        # element and position columns equal (the potentials agree to the
        # CG tolerance only)
        assert [l.split()[:4] for l in got] == [l.split()[:4] for l in want]
    run = facts[0][case]
    assert run["presolve"][0]["phase"] == "boundary"
    # one all-gather an event and a superstep's Poisson at least; the
    # neighbour exchanges go to both sides
    assert run["counts"]["all_gather"] >= sum(run["n_events"]) + RUN_STEPS
    assert run["counts"]["p2p"] > 0


@pytest.mark.parametrize("name,match", [
    ("halo_width", "ValueError: halo width 275 exceeds slab size 256"),
    ("transport_dense", "ValueError: halo transport requires transport='blocked'"),
    ("heat_dense", "ValueError: halo local heating requires .*heat_solver = cg"),
    ("replicate", "runs: decomposition='replicate', 1 superstep"),
    ("world_size", "ValueError: make_mesh: need 3 devices, the process group has 4 ranks"),
])
def test_halo_raises(ranks, name, match):
    import re

    for f in ranks[2]:
        assert re.match(match, f["raises"][name]), f["raises"][name]


def test_multihost_without_launcher(monkeypatch):
    from devicekmc_tpu_torch.parallel import multihost

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    assert multihost.initialize(device="cpu") is False
    assert multihost.is_coordinator() and multihost.process_count() == 1


def test_multihost_failed_start_raises(monkeypatch):
    """A start that cannot reach its coordinator raises (no single-process
    fallback) and leaves no group behind."""
    from devicekmc_tpu_torch.parallel import multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]    # closed again: nobody listens there
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    with pytest.raises((RuntimeError, TimeoutError)):
        multihost.initialize(device="cpu", timeout=datetime.timedelta(seconds=3))
    assert not torch.distributed.is_initialized()
