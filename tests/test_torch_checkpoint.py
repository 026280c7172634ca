"""Full-state checkpoint and resume in the port: the round trip, a
bit-exact resume through a bias boundary (per step and batched), a payload
without the boundary residual, the npz exchanged with the JAX package in
both directions; the dcp and dcp_async directory backends (the
counterparts of the JAX package's orbax and orbax_async) against npz, a
background write overlapped with supersteps, and the port resumed from its
dcp directory beside the JAX package resumed from its orbax one."""

import hashlib
import os

import numpy as np
import pytest
import torch

from torch_parity import configs, small_structure

torch.set_num_threads(1)

#: the fields a resume must reproduce bit for bit
RESUME_FIELDS = ("element", "charge", "key", "kmc_time", "I_macro",
                 "virtual_potentials", "T_bg", "cvac_prev", "Vd_prev", "CB_edge")


def _np(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _make_cfg(tmp_path, **over):
    """tests/test_engine.py's device and configuration (dense transport,
    global heating) in the port."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=6, ny=3, nz=3, seed=3)
    base = dict(
        lattice=list(s.lattice), nn_dist=3.0, pbc=False,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, pristine=True, initial_vacancy_concentration=0.1,
        A=6.25e-19, V_switch=[2.0], t_switch=[1e-12], log_freq=2,
        output_dir=str(tmp_path))
    base.update(over)
    return KMCConfig(**base), s


def _sim(cfg, s, **kw):
    from devicekmc_tpu_torch.engine import Simulation

    return Simulation(cfg, elements=s.elements, coords=s.coords, device="cpu", **kw)


def test_checkpoint_roundtrip(tmp_path):
    """Mirror of tests/test_engine.py::test_checkpoint_roundtrip, and every
    field and cap of the payload back as it was."""
    cfg, s = _make_cfg(tmp_path)
    sim = _sim(cfg, s)
    sim.run_bias_point(2.0, 1e-12, max_steps=2)
    ckpt = str(tmp_path / "ckpt.npz")
    sim.save_checkpoint(ckpt)

    sim2 = _sim(cfg, s)
    sim2.load_checkpoint(ckpt)
    assert torch.equal(sim2.state.element, sim.state.element)
    assert sim2.state.key == sim.state.key
    assert sim2.state.T_bg == sim.state.T_bg
    assert sim2._pos == sim._pos == (0, 1)
    a, b = sim._checkpoint_payload(), sim2._checkpoint_payload()
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f], equal_nan=True), f
    assert a["key"].dtype == np.uint32 and a["key"].shape == (2,)
    assert a["step_count"].dtype == np.int32


#: blocked transport on the same device (mixed precision, stored metal block,
#: persistent tunnel rows): what a resume rebuilds besides the dense path
BLOCKED = dict(transport="blocked", precision="mixed", transport_tol=1e-11,
               transport_incremental="on")


@pytest.mark.parametrize("batch_steps,extra", [(1, {}), (4, {}), (1, BLOCKED),
                                               (4, BLOCKED)],
                         ids=["per-step", "batched", "blocked-per-step", "blocked-batched"])
def test_checkpoint_resume_bit_exact_through_bias_boundary(tmp_path, batch_steps, extra):
    """Mirror of tests/test_engine.py::
    test_checkpoint_resume_bit_exact_through_bias_boundary: a run saved in
    the middle of bias point 1 and resumed in a fresh Simulation (C), and one
    saved at the bias boundary and resumed through run() (D), end in the
    uninterrupted run's state bit for bit, and C's snapshots of bias 1 are
    byte-equal to it; per step and with batch_steps = 4 (log_freq 2: the
    snapshot steps run alone, the others in batches), with the dense and
    with the blocked transport (whose persistent tunnel rows a resume
    rebuilds from scratch)."""
    T = 1e30
    mk = lambda d: _make_cfg(d, V_switch=[2.0, 2.1], t_switch=[T, T],
                             batch_steps=batch_steps, **extra)

    da = tmp_path / "a"; da.mkdir()
    cfg_a, s = mk(da)
    sim_a = _sim(cfg_a, s)
    assert sim_a.params.transport_incremental == bool(extra)
    sim_a.run_bias_point(2.0, T, max_steps=1)
    sim_a._pos = (1, 0)
    ra = sim_a.run_bias_point(2.1, T, max_steps=4)
    assert ra["steps"] == 4

    db = tmp_path / "b"; db.mkdir()
    cfg_b, _ = mk(db)
    sim_b = _sim(cfg_b, s)
    sim_b.run_bias_point(2.0, T, max_steps=1)
    ck_boundary = str(tmp_path / "boundary.npz")
    sim_b._pos = (1, 0)
    sim_b.save_checkpoint(ck_boundary)
    sim_b.run_bias_point(2.1, T, max_steps=2)
    assert sim_b._pos == (1, 2)
    ckpt = str(tmp_path / "mid.npz")
    sim_b.save_checkpoint(ckpt)

    dc = tmp_path / "c"; dc.mkdir()
    cfg_c, _ = mk(dc)
    sim_c = _sim(cfg_c, s)
    sim_c.load_checkpoint(ckpt)
    assert sim_c._pos == (1, 2)
    sim_c.run_bias_point(2.1, T, max_steps=4, resume_step=2)
    assert [st["step"] for st in sim_c.step_log] == [2, 3]

    dd = tmp_path / "d"; dd.mkdir()
    cfg_d, _ = mk(dd)
    sim_d = _sim(cfg_d, s)
    sim_d.load_checkpoint(ck_boundary)
    assert sim_d._pos == (1, 0)
    sim_d.run(max_steps_per_bias=4)
    assert sim_d._pos == (1, 4)

    for sim_x, tag in ((sim_c, "mid-bias"), (sim_d, "boundary")):
        for f in RESUME_FIELDS:
            np.testing.assert_array_equal(_np(getattr(sim_x.state, f)),
                                          _np(getattr(sim_a.state, f)),
                                          err_msg=f"{tag}:{f}")
    fa, fc = da / "Results_2.100000", dc / "Results_2.100000"
    snaps_c = sorted(os.listdir(fc), key=lambda f: int(f.split("_")[1].split(".")[0]))
    assert snaps_c == ["snapshot_2.xyz", "snapshot_4.xyz"]
    for snap in snaps_c:
        assert (fa / snap).read_text() == (fc / snap).read_text(), snap


def test_legacy_checkpoint_forces_full_solve(tmp_path):
    """Mirror of tests/test_boundary_incremental.py::
    test_legacy_checkpoint_forces_full_solve: a payload without the
    boundary residual restores Vd_prev = nan, so that the first resumed step
    solves the boundary network in full and writes the anchor back."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=28, ny=2, nz=2, seed=5)

    def cfg(d):
        d.mkdir()
        return KMCConfig(
            lattice=list(s.lattice), nn_dist=3.0, pbc=False,
            num_atoms_first_layer=s.num_atoms_first_layer,
            num_layers_contact=s.num_layers_contact,
            num_atoms_contact=s.num_atoms_contact, layers=s.layers,
            solve_potential=True, perturb_structure=True, pristine=True,
            initial_vacancy_concentration=0.15, V_switch=[4.0], t_switch=[1.0],
            log_freq=1000, output_dir=str(d), active_rows_cap=0,
            event_mode="incremental", boundary_incremental=True)

    sim = _sim(cfg(tmp_path / "ck"), s)
    sim.run_bias_point(4.0, 1e30, max_steps=10)
    assert sim._pos == (0, 10)
    full = str(tmp_path / "full.npz")
    sim.save_checkpoint(full)
    payload = sim._checkpoint_payload()
    payload.pop("boundary_r")
    payload.pop("boundary_b")
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, **payload)

    after = {}
    for name, path in (("legacy", legacy), ("full", full)):
        sim2 = _sim(cfg(tmp_path / name), s)
        sim2.load_checkpoint(path)
        assert np.isnan(sim2.state.Vd_prev) == (name == "legacy")
        assert bool(sim2.state.boundary_r.any()) == (name == "full")
        sim2.run_bias_point(4.0, 1e30, max_steps=11, resume_step=10)
        after[name] = sim2.state
    # the legacy resume solved the network anew and wrote the residual
    # anchor back; the trajectory goes on as from the full payload
    leg, ful = after["legacy"], after["full"]
    assert leg.Vd_prev == 4.0 and bool(leg.boundary_r.any())
    assert torch.equal(leg.element, ful.element)
    np.testing.assert_allclose(leg.potential_boundary.numpy(),
                               ful.potential_boundary.numpy(), rtol=0, atol=1e-6)


def test_checkpoint_rejects_orbax_and_other_structures(tmp_path):
    """A path that is not *.npz writes a dcp directory by default (the JAX
    package's default there is orbax); an orbax backend raises a ValueError
    that names its counterpart, dcp or dcp_async, and npz; a payload of
    another size (a JAX geometry padded past N) raises on load."""
    import torch.distributed.checkpoint as dcp

    cfg, s = _make_cfg(tmp_path)
    sim = _sim(cfg, s)
    sim.save_checkpoint(str(tmp_path / "ck"))
    saved = dcp.FileSystemReader(str(tmp_path / "ck")).read_metadata().state_dict_metadata
    assert set(saved) == set(sim._checkpoint_payload())
    for path, backend, twin in ((str(tmp_path / "ck"), "orbax", "dcp"),
                                (str(tmp_path / "ck.npz"), "orbax_async", "dcp_async")):
        with pytest.raises(ValueError, match=f"'{twin}'.*npz"):
            sim.save_checkpoint(path, backend=backend)
        with pytest.raises(ValueError, match=f"'{twin}'.*npz"):
            sim.load_checkpoint(path, backend=backend)
    assert "ck.npz" not in os.listdir(tmp_path)
    payload = sim._checkpoint_payload()
    payload["potential_boundary"] = np.zeros(sim.geom.N + 8)
    np.savez(str(tmp_path / "padded.npz"), **payload)
    with pytest.raises(ValueError, match="potential_boundary"):
        _sim(cfg, s).load_checkpoint(str(tmp_path / "padded.npz"))
    torch.save({}, str(tmp_path / "other"))
    dcp.save({"potential_boundary": torch.from_numpy(payload["potential_boundary"])},
             storage_writer=dcp.FileSystemWriter(str(tmp_path / "padded"), overwrite=True),
             no_dist=True)
    with pytest.raises(ValueError, match="potential_boundary"):
        _sim(cfg, s).load_checkpoint(str(tmp_path / "padded"))


# ---------------------------------------------------------------------------
# the directory backends (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

def _same_payload(a, b):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f], equal_nan=True), f


def test_checkpoint_dcp_backend(tmp_path):
    """Mirror of tests/test_engine.py::test_checkpoint_orbax_backend: a dcp
    directory round-trips the full payload (state, caps, driver position)
    as npz does, every field of every dtype."""
    cfg, s = _make_cfg(tmp_path)
    sim = _sim(cfg, s)
    sim.run_bias_point(2.0, 1e-12, max_steps=2)
    sim._pos = (0, 2)
    sim.save_checkpoint(str(tmp_path / "ck_dcp"), backend="dcp")
    sim.save_checkpoint(str(tmp_path / "ck.npz"))

    sim2 = _sim(cfg, s)
    sim2.load_checkpoint(str(tmp_path / "ck_dcp"), backend="dcp")
    sim3 = _sim(cfg, s)
    sim3.load_checkpoint(str(tmp_path / "ck.npz"))
    assert sim2._pos == sim3._pos == (0, 2)
    _same_payload(sim2._checkpoint_payload(), sim3._checkpoint_payload())
    _same_payload(sim2._checkpoint_payload(), sim._checkpoint_payload())


def test_checkpoint_dcp_async_backend(tmp_path):
    """Mirror of tests/test_engine.py::test_checkpoint_orbax_async_backend:
    a second dcp_async save right after the first waits for it, a load waits
    for the write in flight, and the restored payload equals npz's."""
    cfg, s = _make_cfg(tmp_path)
    sim = _sim(cfg, s)
    sim.run_bias_point(2.0, 1e-12, max_steps=2)
    sim._pos = (0, 2)
    sim.save_checkpoint(str(tmp_path / "ck_a1"), backend="dcp_async")
    assert sim._pending_save is not None
    sim.run_bias_point(2.0, 1e-12, max_steps=1)
    sim._pos = (0, 3)
    sim.save_checkpoint(str(tmp_path / "ck_a2"), backend="dcp_async")
    sim.save_checkpoint(str(tmp_path / "ck.npz"))
    # the npz save waited for ck_a2: nothing is left in flight
    assert sim._pending_save is None
    sim.save_checkpoint(str(tmp_path / "ck_a3"), backend="dcp_async")

    sim2 = _sim(cfg, s)
    sim2.load_checkpoint(str(tmp_path / "ck_a2"), backend="dcp_async")
    sim3 = _sim(cfg, s)
    sim3.load_checkpoint(str(tmp_path / "ck.npz"))
    assert sim2._pos == sim3._pos == (0, 3)
    _same_payload(sim2._checkpoint_payload(), sim3._checkpoint_payload())
    # a load waits for the write in flight, which may be the one it reads
    sim.load_checkpoint(str(tmp_path / "ck_a3"))
    assert sim._pending_save is None and sim._pos == (0, 3)
    _same_payload(sim._checkpoint_payload(), sim3._checkpoint_payload())


def test_dcp_async_overlaps_supersteps(tmp_path):
    """A dcp_async save returns with its payload copied; the run takes 3 more
    supersteps before the wait, and the directory holds the state at the
    save, not after them; run() waits at its end.  A background write that
    fails raises at the next wait, and only once."""
    cfg, s = _make_cfg(tmp_path, V_switch=[2.0], t_switch=[1e30])
    sim = _sim(cfg, s)
    sim.run(max_steps_per_bias=2)
    at_save = sim._checkpoint_payload()
    sim.save_checkpoint(str(tmp_path / "ck"), backend="dcp_async")
    sim.run_bias_point(2.0, 1e30, max_steps=5, resume_step=2)
    after = sim._checkpoint_payload()
    assert not np.array_equal(after["element"], at_save["element"])
    sim.wait_for_checkpoint()
    back = _sim(cfg, s)
    back.load_checkpoint(str(tmp_path / "ck"))
    _same_payload(back._checkpoint_payload(), at_save)
    sim.save_checkpoint(str(tmp_path / "ck2"), backend="dcp_async")
    sim.run(max_steps_per_bias=6)
    assert sim._pending_save is None

    # DCP's CheckpointException derives from BaseException
    from torch.distributed.checkpoint.api import CheckpointException

    (tmp_path / "blocked").write_text("a file where the directory would go")
    sim.save_checkpoint(str(tmp_path / "blocked" / "ck"), backend="dcp_async")
    with pytest.raises(CheckpointException, match="Not a directory"):
        sim.wait_for_checkpoint()
    sim.wait_for_checkpoint()
    sim.save_checkpoint(str(tmp_path / "blocked" / "ck"), backend="dcp_async")
    with pytest.raises(CheckpointException, match="Not a directory"):
        sim.save_checkpoint(str(tmp_path / "ck3"))
    assert not os.path.exists(tmp_path / "ck3")


# ---------------------------------------------------------------------------
# one npz, both packages
# ---------------------------------------------------------------------------

VD = 10.0


def _hash(elem_np):
    return hashlib.sha256(np.asarray(elem_np).astype(np.int32).tobytes()).hexdigest()[:16]


def _pair(tmp_path, name):
    """(JAX Simulation, port Simulation) of the transport slice's
    configuration (tests/test_torch_transport_slice.py: the small stack,
    blocked transport, mixed precision, transport_tol 1e-11)."""
    from devicekmc_tpu.engine import Simulation as JSim
    from devicekmc_tpu_torch.engine import Simulation as TSim

    s = small_structure()
    jcfg, tcfg = configs(
        s, pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3,
        rnd_seed_kmc=7, precision="mixed", solve_current=True, transport="blocked",
        poisson_kernel="pallas", V_switch=[VD], t_switch=[1e30], transport_tol=1e-11)
    for tag, cfg in (("jax", jcfg), ("torch", tcfg)):
        d = tmp_path / name / tag
        d.mkdir(parents=True)
        cfg.output_dir = str(d)
    return (JSim(jcfg, elements=s.elements, coords=s.coords),
            TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu"))


def _continue(sim, records, to_np):
    """Run the loaded bias point on from its step, recording each step's
    element hash, events and current."""
    step = sim._superstep

    def wrapped(state, Vd, *rest):
        out = step(state, Vd, *rest)
        records.append((_hash(to_np(out[0].element)), int(out[2]["n_events"]),
                        float(out[2]["Current [uA]"])))
        return out

    sim._superstep = wrapped
    sim.run_bias_point(VD, 1e30, max_steps=5, resume_step=sim._pos[1])


def _same(a, b):
    return a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=np.issubdtype(a.dtype, np.floating))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_exchanged_with_jax(tmp_path, writer):
    """One package runs 2 supersteps and saves; fresh simulations of both
    packages load that npz and run steps 2-4: element hashes and events
    equal step for step, the current within 1e-5 (two independent mixed
    solves at tolerance 1e-11).  The port, loading, holds every field of
    the file and writes it back as read."""
    jw, tw = _pair(tmp_path, "writer")
    w = jw if writer == "jax" else tw
    w.run_bias_point(VD, 1e30, max_steps=2)
    path = str(tmp_path / "ck.npz")
    w.save_checkpoint(path)
    with np.load(path) as data:
        saved = {f: data[f] for f in data.files}
    assert int(saved["pos_bias_step"]) == 2

    jr, tr = _pair(tmp_path, "readers")
    jr.load_checkpoint(path)
    tr.load_checkpoint(path)
    back = tr._checkpoint_payload()
    assert set(back) == set(saved)
    for f in saved:
        assert _same(back[f], saved[f]), f
    jrec, trec = [], []
    _continue(jr, jrec, np.asarray)
    jr._flush()
    _continue(tr, trec, lambda t: t.numpy())
    assert len(jrec) == len(trec) == 3
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b[0] == a[0] and b[1] == a[1], f"step {k + 2}"
        assert b[2] == pytest.approx(a[2], rel=1e-5), f"step {k + 2}"


@pytest.mark.parametrize("backend", ["dcp", "dcp_async"])
def test_dcp_resume_beside_jax_orbax(tmp_path, backend):
    """The JAX package saves an orbax directory after 2 supersteps and the
    port a dcp one (``backend``) after the same 2; fresh simulations of each
    package resume from their own directory and run steps 2-4: element
    hashes and events equal step for step, the current within 1e-5 (as
    test_npz_exchanged_with_jax)."""
    pytest.importorskip("orbax.checkpoint")
    jw, tw = _pair(tmp_path, "writers")
    jw.run_bias_point(VD, 1e30, max_steps=2)
    tw.run_bias_point(VD, 1e30, max_steps=2)
    jw.save_checkpoint(str(tmp_path / "jax_ck"), backend="orbax")
    tw.save_checkpoint(str(tmp_path / "port_ck"), backend=backend)
    tw.wait_for_checkpoint()

    jr, tr = _pair(tmp_path, "readers")
    jr.load_checkpoint(str(tmp_path / "jax_ck"), backend="orbax")
    tr.load_checkpoint(str(tmp_path / "port_ck"))
    assert jr._pos == tr._pos == (0, 2)
    jrec, trec = [], []
    _continue(jr, jrec, np.asarray)
    jr._flush()
    _continue(tr, trec, lambda t: t.numpy())
    assert len(jrec) == len(trec) == 3
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b[0] == a[0] and b[1] == a[1], f"step {k + 2}"
        assert b[2] == pytest.approx(a[2], rel=1e-5), f"step {k + 2}"
