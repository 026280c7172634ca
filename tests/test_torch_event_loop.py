"""The event-loop wrapper of the port (``ops/kmc_events.py``) on the CPU:
it takes the plain host loop for CPU tensors, which keeps the JAX
package's semantics at the event cap and without a valid event; the tables
it is given; and the random stream of the card kernel's header
(``csrc/threefry.cuh``), compiled for the host, against ``rng.py``."""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import configs, perturbed_state, small_structure, to_port

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "devicekmc_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def sim():
    from devicekmc_tpu.state import build_geometry, build_params, init_state
    from devicekmc_tpu_torch.state import build_params as tparams

    s = small_structure()
    jcfg, tcfg = configs(s)
    jg = build_geometry(s.elements, s.coords, jcfg)
    js = perturbed_state(jg, init_state(jg, jcfg, s.elements), seed=4,
                         n_vac=14, n_od=10, phi_scale=3.0)
    tg, ts = to_port(jg, js)
    return jg, build_params(jcfg), js, tg, tparams(tcfg), ts


def test_wrapper_takes_the_plain_loop_on_cpu(sim, monkeypatch):
    """A superstep on CPU tensors runs the plain loop once and launches no
    kernel."""
    from devicekmc_tpu_torch.ops import kmc_events
    from devicekmc_tpu_torch.physics.events import execute_superstep_incremental

    _, _, _, tg, tp, ts = sim
    calls = []
    plain = kmc_events.kmc_event_loop_plain

    def counted(*a, **kw):
        calls.append(a[0].device.type)
        return plain(*a, **kw)

    monkeypatch.setattr(kmc_events, "kmc_event_loop_plain", counted)
    before = kmc_events.kmc_event_loop.launches
    res = execute_superstep_incremental(tg, tp, ts)
    assert calls == ["cpu"] and kmc_events.kmc_event_loop.launches == before
    assert res.n_events > 5


@pytest.mark.parametrize("max_events", [1, 3])
@pytest.mark.parametrize("cap", [0, 128])
def test_event_cap_matches_jax(sim, max_events, cap):
    """max_events_per_superstep hit exactly, with the JAX package's
    elements, charges, key and step time (f64)."""
    from devicekmc_tpu.physics import events as jev
    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.physics import events as tev

    jg, jp, js, tg, tp, ts = sim
    jp = jp.replace(active_rows_cap=cap, max_events_per_superstep=max_events)
    tp = dataclasses.replace(tp, active_rows_cap=cap, max_events_per_superstep=max_events)
    ref = jev.execute_superstep(jg, jp, js)
    got = tev.execute_superstep(tg, tp, ts)
    assert got.n_events == int(ref.n_events) == max_events
    np.testing.assert_array_equal(got.state.element.numpy(), np.asarray(ref.state.element))
    np.testing.assert_array_equal(got.state.charge.numpy(), np.asarray(ref.state.charge))
    assert got.state.key == rng.key_from_array(ref.state.key)
    assert got.step_time == pytest.approx(float(ref.step_time), rel=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_no_valid_event(sim, dtype):
    """A table without a positive rate (psum = 0): event_time = inf, no
    event, the key split once, elements and charges untouched."""
    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.ops.kmc_events import BLOCK, kmc_event_loop

    _, _, _, tg, tp, ts = sim
    N, m = tg.N, tg.max_nn
    n_blocks = -(-N // BLOCK)
    aidx = torch.arange(N, dtype=torch.int32)
    element, charge, res = kmc_event_loop(
        torch.zeros((N, m), dtype=dtype), torch.zeros(n_blocks * BLOCK, dtype=torch.float64),
        torch.zeros(n_blocks, dtype=torch.float64), aidx, aidx, tg.neigh_idx, tg.rev_slot,
        ts.element, ts.charge, ts.key, 1.0 / tp.freq, 100, torch.float64)
    t, count, k0, k1 = res.tolist()
    assert t == float("inf") and count == 0
    assert (int(k0), int(k1)) == rng.split(ts.key, 3)[0]
    assert torch.equal(element, ts.element) and torch.equal(charge, ts.charge)
    assert element.data_ptr() != ts.element.data_ptr()


@pytest.mark.parametrize("cap", [0, 128])
def test_incremental_tables(sim, cap):
    """The loop's inputs: rows of the candidate sites {d, Od, V} in site
    order (fill rows zero), the row of each site and -1 where it has none,
    f64 row sums padded to whole blocks and block sums that add them."""
    from devicekmc_tpu_torch.ops.kmc_events import BLOCK
    from devicekmc_tpu_torch.physics.events import build_rate_table, incremental_tables

    _, _, _, tg, tp, ts = sim
    tp = dataclasses.replace(tp, active_rows_cap=cap)
    prob, row_sums, block_sums, aidx, inv, n_active = incremental_tables(tg, tp, ts)
    assert aidx.dtype == inv.dtype == torch.int32 and inv.shape == (tg.N,)
    e = ts.element.numpy()
    src = np.nonzero(np.isin(e, [0, 1, 2]))[0]
    if cap:
        n = int(n_active)
        assert n == src.size and prob.shape[0] == cap
        np.testing.assert_array_equal(aidx[:n].numpy(), src)
        assert not prob[n:].any()
        full = build_rate_table(tg, tp, ts)
        torch.testing.assert_close(prob[:n], full[src], rtol=0, atol=0)
        expect_inv = np.full(tg.N, -1)
        expect_inv[src] = np.arange(n)
        np.testing.assert_array_equal(inv.numpy(), expect_inv)
    else:
        assert n_active is None and prob.shape[0] == tg.N
        np.testing.assert_array_equal(aidx.numpy(), np.arange(tg.N))
        np.testing.assert_array_equal(inv.numpy(), np.arange(tg.N))
    n_rows = prob.shape[0]
    assert row_sums.dtype == block_sums.dtype == torch.float64
    assert row_sums.shape == (block_sums.shape[0] * BLOCK,) and not row_sums[n_rows:].any()
    torch.testing.assert_close(row_sums[:n_rows], prob.double().sum(dim=1))
    torch.testing.assert_close(block_sums, row_sums.reshape(-1, BLOCK).sum(dim=1))


HARNESS = r"""
#define __host__
#define __device__
#define __forceinline__ inline
#include "threefry.cuh"
extern "C" void draws(unsigned k0, unsigned k1, int n, unsigned* keys, double* u64,
                      float* u32) {
  TfKey key = {k0, k1};
  for (int e = 0; e < n; ++e) {
    const TfKey ks = tf_split(key, 1u), kt = tf_split(key, 2u);
    key = tf_split(key, 0u);
    keys[2 * e] = key.k0; keys[2 * e + 1] = key.k1;
    u64[2 * e] = tf_uniform_f64(ks); u64[2 * e + 1] = tf_uniform_f64(kt);
    u32[2 * e] = tf_uniform_f32(ks); u32[2 * e + 1] = tf_uniform_f32(kt);
  }
}
"""


@pytest.mark.parametrize("seed", [7, 2**40 + 3])
def test_threefry_header_matches_rng(tmp_path, seed):
    """csrc/threefry.cuh compiled for the host with g++: 500 successive
    splits and the f64 and f32 draws of k_sel and k_time, bit for bit
    against rng.py (the card kernel runs the same integer code)."""
    from devicekmc_tpu_torch import rng

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(HARNESS)
    lib = tmp_path / "libharness.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}", "-o",
                    str(lib), str(src)], check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).draws
    n = 500
    keys = np.zeros((n, 2), np.uint32)
    u64 = np.zeros((n, 2), np.float64)
    u32 = np.zeros((n, 2), np.float32)
    key = rng.prng_key(seed)
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn(key[0], key[1], n, keys.ctypes.data, u64.ctypes.data, u32.ctypes.data)
    for e in range(n):
        key, k_sel, k_time = rng.split(key, 3)
        assert (int(keys[e, 0]), int(keys[e, 1])) == key
        assert u64[e].tolist() == [rng.uniform(k_sel, np.float64),
                                   rng.uniform(k_time, np.float64)]
        assert u32[e].tolist() == [rng.uniform(k_sel, np.float32),
                                   rng.uniform(k_time, np.float32)]
