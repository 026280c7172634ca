"""The transport superstep as one captured graph with the stored metal block
(what transport_cc="auto" picks) in mixed precision and in f64: the engine's
capture, the graph's body against the eager engine bit for bit and against
the JAX package's jitted superstep, the f64 device loop's plain version
against ``cg_solve``, and the stored block's product
(``torch_transport_graph`` holds the configurations)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_transport_graph import (F64, VD, _port, bit_cases, check_bit_for_bit,
                                   check_engine_runs_on_the_graph, check_matches_jax)

torch.set_num_threads(1)

#: this file's configurations (the stored metal block, mixed and f64)
GROUP = ["stored-heat-off", "stored-heat-global", "stored-heat-local-cg", "f64-heat-off",
         "f64-heat-global"]


@pytest.mark.parametrize("config", ["stored-heat-local-cg", "f64-heat-global"])
def test_engine_runs_the_new_configurations_on_the_graph(tmp_path, config):
    """The configuration runs on SuperstepGraph, per step and in batches
    (torch_transport_graph.check_engine_runs_on_the_graph)."""
    check_engine_runs_on_the_graph(tmp_path, config)


@pytest.mark.parametrize("config,skip,incremental", bit_cases(GROUP))
def test_transport_graph_matches_eager_bit_for_bit(tmp_path, config, skip, incremental):
    """The graph against the eager engine bit for bit, step for step
    (torch_transport_graph.check_bit_for_bit)."""
    check_bit_for_bit(tmp_path, config, skip, incremental)


@pytest.mark.parametrize("config", GROUP)
def test_transport_graph_matches_jax(tmp_path, config):
    """The graph against the JAX package's jitted superstep
    (torch_transport_graph.check_matches_jax)."""
    check_matches_jax(tmp_path, config)


# ---------------------------------------------------------------------------
# the f64 solver and the stored product
# ---------------------------------------------------------------------------

def _f64_system(tmp_path):
    """The f64 stored configuration after two supersteps, its stored solution
    perturbed: the device form's operator and workspace as the warm re-solve
    builds them (the solve run once), and the state."""
    from devicekmc_tpu_torch.ops import transport_cg
    from devicekmc_tpu_torch.physics import current

    sim = _port(tmp_path, "cg64", eager=True, **F64)
    sim.run_bias_point(VD, 1e30, max_steps=2)
    rng = np.random.default_rng(0)
    vp = sim.state.virtual_potentials
    vp = vp * torch.as_tensor(1 + 1e-2 * rng.standard_normal(vp.shape[0]))
    st = dataclasses.replace(sim.state, virtual_potentials=vp, transport_Vd_prev=float("nan"))
    cap = {}
    solve = transport_cg.solve_f64

    def grab(tws, op, x0, go, tol, maxiter):
        cap.update(tws=tws, op=op, x0=x0.clone(), tol=tol, maxiter=maxiter)
        return solve(tws, op, x0, go, tol, maxiter)

    transport_cg.solve_f64 = grab
    try:
        got, mg = current.update_power(sim.geom, sim.params, st, VD, cc=dict(sim._cc),
                                       allow_skip=True)
    finally:
        transport_cg.solve_f64 = solve
    return sim, st, got, mg, cap



def test_transport_f64_plain_loop_matches_cg_solve(tmp_path):
    """The f64 device loop's plain version (transport_cg.solve_f64: the
    stored block's product, transport_blocks, the rows of A p and the
    update, direction and packing) inside the warm re-solve against
    update_power_blocked's f64 branch (ops.cg.cg_solve, Jacobi, criterion
    "pre") on the same state: iterations, the iterate and I_macro bit for
    bit (the same operations in the same order); and against the JAX
    package's cg_solve(criterion="pre") on the same operator, made dense
    from the port's product (x64): the same iterations, the iterate within
    1e-12 of its largest entry (f64 sums in other orders), both meeting the
    criterion."""
    import jax
    import jax.numpy as jnp
    from devicekmc_tpu.ops.cg import cg_solve as jax_cg_solve
    from devicekmc_tpu_torch.physics import current

    sim, st, got, mg, cap = _f64_system(tmp_path)
    ref, mr = current.update_power_blocked(sim.geom, sim.params, st, VD, cc=sim._cc,
                                           precond="jacobi")
    assert mr["transport_converged"] and mg["transport_converged"]
    assert mg["cg_iters_power"] == mr["cg_iters_power"] > 0
    assert got.I_macro == ref.I_macro
    assert torch.equal(got.virtual_potentials, ref.virtual_potentials)
    assert np.isnan(mg["transport_rel0"]) and np.isnan(mr["transport_rel0"])

    op = cap["op"]
    blk = current.assemble_X_blocks(sim.geom, sim.params, st, cc=sim._cc["cc"])
    nsub = op.b.shape[0]
    eye = torch.eye(nsub + 1, dtype=torch.float64)
    A = torch.stack([current._apply_X_blocks(blk, eye[j], torch.float64)[:nsub]
                     for j in range(nsub)], dim=1)
    assert jax.config.jax_enable_x64
    Aj = jnp.asarray(A.numpy())
    res = jax_cg_solve(lambda x: Aj @ x, jnp.asarray(op.b.numpy()),
                       x0=jnp.asarray(cap["x0"].numpy()),
                       diag=jnp.asarray(blk["diag"][:nsub].numpy()), tol=cap["tol"],
                       maxiter=cap["maxiter"], criterion="pre")
    jx, jit = np.asarray(res.x), int(res.iters)
    assert bool(res.converged) and Aj.dtype == jnp.float64
    assert jit == mg["cg_iters_power"]
    v = got.virtual_potentials[:nsub].numpy()
    assert np.abs(v - jx).max() <= 1e-12 * np.abs(jx).max()



def test_stored_matvec_plain_is_the_product():
    """stored_matvec_out on CPU tensors writes the plain version, the stored
    block's T_cc @ x in its dtype (what physics.current._apply_X_blocks
    computes), into the caller's buffer, f32 and f64."""
    from devicekmc_tpu_torch.ops.transport_cg import stored_matvec_out, stored_matvec_plain

    g = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        for n in (1, 7, 130):
            T = torch.randn((n, n), generator=g, dtype=dtype)
            x = torch.randn(n, generator=g, dtype=dtype)
            y = torch.full((n,), float("nan"), dtype=dtype)
            stored_matvec_out(T, x, y)
            assert torch.equal(y, torch.matmul(T, x)) and torch.equal(y, stored_matvec_plain(T, x))

