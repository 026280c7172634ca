"""The cold transport pre-solve in segments (``solver_chunk_iters > 0``) in
f64 with the blocked solve, in both packages: each segment is a fresh
``update_power`` that restarts the deflated CG from the committed
``virtual_potentials``, so the segments need more iterations than one call
(a shared property of the JAX package's ``_chunked_transport``,
``devicekmc_tpu/engine.py:832-855``, that the port reproduces; ROADMAP §3
item 2).  On the 256-site stack; JAX on the CPU in x64."""

import numpy as np
import pytest
import torch

from torch_parity import configs, small_structure

torch.set_num_threads(1)

VD = 10.0
#: iterations a segment: the stack's cold f64 solve takes 32 in one call
CHUNK = 12
BASE = dict(pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3, rnd_seed_kmc=7,
            precision="f64", solve_current=True, transport="blocked", transport_cc="stored",
            transport_precond="deflated", coarse_slabs=4, poisson_compact_cap=64,
            V_switch=[VD], t_switch=[1e30], transport_tol=1e-11)


def _presolve(module, sim):
    """The segments of ``sim``'s cold transport pre-solve (its
    ``run_bias_point`` with no superstep): each one's iterations and
    convergence flag, from the engine module's ``_phase_power_chunk``."""
    segs = []
    chunk = module._phase_power_chunk

    def counted(*a, **kw):
        st, m = chunk(*a, **kw)
        segs.append((int(m["cg_iters_power"]), bool(m["transport_converged"])))
        return st, m

    module._phase_power_chunk = counted
    try:
        sim.run_bias_point(VD, 1e30, max_steps=0)
    finally:
        module._phase_power_chunk = chunk
    return segs


def test_f64_cold_transport_segments_match_jax(tmp_path):
    """With CHUNK iterations a segment both packages take the same segments
    (each segment's iterations and flag) and commit the same
    virtual_potentials (within 1e-11 of their scale: f64 sums in other
    orders); the segments' total exceeds the iterations of the same solve
    in one segment: both packages restart the CG each segment."""
    import devicekmc_tpu.engine as jeng
    import devicekmc_tpu_torch.engine as teng

    s = small_structure()
    sims = {}
    for tag, chunk in (("seg", CHUNK), ("one", 1000)):
        jcfg, tcfg = configs(s, solver_chunk_iters=chunk, **BASE)
        for name, cfg in (("jax", jcfg), ("torch", tcfg)):
            d = tmp_path / f"{tag}_{name}"
            d.mkdir()
            cfg.output_dir = str(d)
        sims[tag] = (jcfg, tcfg)
    jsim = jeng.Simulation(sims["seg"][0], elements=s.elements, coords=s.coords)
    tsim = teng.Simulation(sims["seg"][1], elements=s.elements, coords=s.coords, device="cpu")
    jsegs, tsegs = _presolve(jeng, jsim), _presolve(teng, tsim)
    assert tsegs == jsegs
    assert len(tsegs) > 2 and tsegs[-1][1] and not any(ok for _, ok in tsegs[:-1])
    total = sum(n for n, _ in tsegs)
    assert tsim.presolve_log[-1]["phase"] == "transport"
    assert tsim.presolve_log[-1]["cg_iters"] == total
    vj = np.asarray(jsim.state.virtual_potentials)
    vt = tsim.state.virtual_potentials.numpy()
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-11 * np.abs(vj).max())
    # the same cold solve in one segment
    one = teng.Simulation(sims["one"][1], elements=s.elements, coords=s.coords, device="cpu")
    (n_one, ok), = _presolve(teng, one)
    assert ok and 0 < n_one < total
