"""The ported slice end to end: Simulation.run_bias_point of the headline
module set (charge, boundary CG, compacted Poisson, events) through both
packages on the small stack, step by step."""

import hashlib

import numpy as np
import pytest
import torch

from torch_parity import configs, small_structure

torch.set_num_threads(1)

STEPS = 6
VD = 10.0


def _recorder(step_fn, records, to_np):
    def wrapped(state, Vd, *rest):
        out = step_fn(state, Vd, *rest)
        st = out[0]
        phi = to_np(st.potential_boundary) + to_np(st.potential_charge)
        records.append({
            "elem_hash": hashlib.sha256(
                to_np(st.element).astype(np.int32).tobytes()).hexdigest()[:16],
            "n_events": int(out[2]["n_events"]),
            "step_time": float(out[1]),
            "phi": phi,
            "phi_charge": to_np(st.potential_charge),
        })
        return out
    return wrapped


def _parse(path):
    steps, cur = [], None
    for line in open(path):
        if line.startswith("KMC step count"):
            cur = {}
            steps.append(cur)
        elif cur is not None and ": " in line:
            k, v = line.rsplit(": ", 1)
            cur[k] = v.strip()
    return steps


def _run_both(tmp_path, precision, steps=STEPS, **kw):
    from devicekmc_tpu.engine import Simulation as JSim
    from devicekmc_tpu_torch.engine import Simulation as TSim

    s = small_structure()
    jcfg, tcfg = configs(
        s, pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3,
        rnd_seed_kmc=7, precision=precision, V_switch=[VD], t_switch=[1e30],
        **kw,
    )
    jcfg.output_dir = str(tmp_path / "jax")
    tcfg.output_dir = str(tmp_path / "torch")
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jsim = JSim(jcfg, elements=s.elements, coords=s.coords)
    tsim = TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu")
    jrec, trec = [], []
    jsim._superstep = _recorder(jsim._superstep, jrec, np.asarray)
    tsim._superstep = _recorder(tsim._superstep, trec, lambda t: t.numpy())
    jsim.run_bias_point(VD, 1e30, max_steps=steps)
    jsim._flush()
    tsim.run_bias_point(VD, 1e30, max_steps=steps)
    assert len(jrec) == len(trec) >= steps
    return jrec, trec, _parse(tmp_path / "jax" / "output.txt"), \
        _parse(tmp_path / "torch" / "output.txt")


# f64: potentials to 1e-9 relative (boundary CG at solver_tol 1e-12 and the
# exact-erfc Poisson sweep, both f64), step times to 1e-9 relative.
# mixed: the Poisson sweep is f32 (A&S erfc kernel and its plain version,
# sums in another order: 1e-6 of the potential scale) and the rate table is
# f32, which moves the residence times by ~1e-5 relative.
@pytest.mark.parametrize("precision,phi_tol,t_tol,kw", [
    ("f64", 1e-9, 1e-9, {}),
    ("mixed", 1e-6, 1e-4, dict(poisson_kernel="pallas", ell_gather_kernel="pallas")),
])
def test_run_bias_point_matches_jax(tmp_path, precision, phi_tol, t_tol, kw):
    """Element hashes and event counts equal at every step, potentials and
    step times within the stated tolerances, and output.txt carries the same
    keys with the same counts (timings aside)."""
    jrec, trec, jout, tout = _run_both(tmp_path, precision, **kw)
    assert sum(r["n_events"] for r in jrec) >= STEPS
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b["elem_hash"] == a["elem_hash"], f"step {k}"
        assert b["n_events"] == a["n_events"], f"step {k}"
        assert b["step_time"] == pytest.approx(a["step_time"], rel=t_tol), k
        scale = np.abs(a["phi"]).max()
        np.testing.assert_allclose(b["phi"], a["phi"], rtol=0,
                                   atol=phi_tol * scale, err_msg=f"step {k}")
    assert len(jout) == len(tout) == STEPS
    for a, b in zip(jout, tout):
        keys = {k for k in a if "calculation time" not in k}
        assert keys == {k for k in b if "calculation time" not in k}
        for k in keys - {"KMC time is"}:
            assert float(b[k]) == float(a[k]), k


@pytest.mark.parametrize("precision,tol", [("f64", 1e-12), ("mixed", 1e-6)])
def test_dense_poisson_route_matches_jax(tmp_path, precision, tol):
    """poisson_compact_cap = 0: the port's dense route (the compacted sweep
    with the whole site axis as its bucket, plain version) against the JAX
    package's O(N^2) poisson_gridless, 8 supersteps at 10 V.  Element hashes
    and event counts equal at every step; potential_charge within tol of its
    largest value: 1e-12 in f64 (the same f64 sums in another order), 1e-6
    in mixed precision (f32 sweeps in another order)."""
    jrec, trec, _, _ = _run_both(tmp_path, precision, steps=8, poisson_compact_cap=0)
    assert sum(r["n_events"] for r in jrec) >= 8
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b["elem_hash"] == a["elem_hash"], f"step {k}"
        assert b["n_events"] == a["n_events"], f"step {k}"
        scale = np.abs(a["phi_charge"]).max()
        assert scale > 0
        np.testing.assert_allclose(b["phi_charge"], a["phi_charge"], rtol=0,
                                   atol=tol * scale, err_msg=f"step {k}")
