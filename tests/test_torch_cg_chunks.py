"""The port's CG with its stop condition read once a chunk of iterations
(``ops.cg.CHUNKS``): bit-equal to a run that reads it every iteration, and
against the JAX package's device while_loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _system(n=120, seed=1, spread=3, shift=0.1):
    """An SPD system with rows scaled over 10^(2 * spread) (the transport
    matrix's kind of spread), a right-hand side and a start vector; 36-91
    iterations at the tolerances below."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + shift * n * np.eye(n)
    D = np.diag(10.0 ** rng.uniform(-spread, spread, n))
    A = D @ A @ D
    return A, rng.standard_normal(n), rng.standard_normal(n) * 1e-3


def _solve(monkeypatch, chunks, A, b, x0, dtype=torch.float64, **kw):
    from devicekmc_tpu_torch.ops import cg

    monkeypatch.setattr(cg, "CHUNKS", chunks)
    ta = torch.as_tensor(A, dtype=dtype)
    calls = []

    def matvec(x):
        calls.append(1)
        return ta @ x

    before = cg.readbacks
    res = cg.cg_solve(matvec, torch.as_tensor(b, dtype=dtype),
                      x0=torch.as_tensor(x0, dtype=dtype),
                      diag=torch.as_tensor(np.diag(A).copy(), dtype=dtype), **kw)
    return res, cg.readbacks - before, len(calls)


SCHEDULES = [(1, 2, 4, 8, 16, 32), (3,), (5, 7), (32,)]


@pytest.mark.parametrize("chunks", SCHEDULES)
@pytest.mark.parametrize("criterion", ["r", "pre"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunked_cg_bit_equal_to_per_iteration(monkeypatch, chunks, criterion, dtype):
    """Every chunk schedule gives the iterate, the iteration count, the
    residual and the converged flag of the per-iteration check bit for bit,
    with fewer read-backs than iterations (one a chunk)."""
    A, b, x0 = _system()
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    ref, ref_reads, _ = _solve(monkeypatch, (1,), A, b, x0, dtype, tol=tol,
                               maxiter=5000, criterion=criterion)
    got, reads, matvecs = _solve(monkeypatch, chunks, A, b, x0, dtype, tol=tol,
                                 maxiter=5000, criterion=criterion)
    assert ref.converged and ref.iters > 20
    assert ref_reads == ref.iters
    assert torch.equal(got.x, ref.x)
    assert (got.iters, got.residual, got.converged) == \
        (ref.iters, ref.residual, ref.converged)
    if chunks != (1,):
        assert reads < ref.iters
    # the start residual, the iterations, and those computed past the stop
    # inside the last chunk: fewer than one chunk
    assert ref.iters + 1 <= matvecs <= ref.iters + max(chunks)


@pytest.mark.parametrize("maxiter", [1, 2, 6, 11, 40])
@pytest.mark.parametrize("chunks", [(1, 2, 4, 8, 16, 32), (8,)])
def test_chunked_cg_maxiter_inside_a_chunk(monkeypatch, maxiter, chunks):
    """The iteration cap where a chunk would run past it: exactly
    ``maxiter`` iterations, not converged, bit-equal to the per-iteration
    run."""
    A, b, x0 = _system()
    kw = dict(tol=1e-14, maxiter=maxiter)
    ref, _, _ = _solve(monkeypatch, (1,), A, b, x0, **kw)
    got, reads, _ = _solve(monkeypatch, chunks, A, b, x0, **kw)
    assert ref.iters == got.iters == maxiter and not got.converged
    assert torch.equal(got.x, ref.x) and got.residual == ref.residual
    assert reads <= maxiter


def test_chunked_cg_converged_start_and_no_iterations(monkeypatch):
    """A start that already meets the tolerance and maxiter = 0: no
    iteration, one read-back each."""
    A, b, _ = _system()
    x_exact = np.linalg.solve(A, b)
    got, reads, _ = _solve(monkeypatch, (1, 2, 4), A, b, x_exact, tol=1e-6)
    assert got.iters == 0 and got.converged and reads == 1
    got, reads, _ = _solve(monkeypatch, (1, 2, 4), A, b, np.zeros_like(b), maxiter=0)
    assert got.iters == 0 and not got.converged and reads == 1


@pytest.mark.parametrize("criterion", ["r", "pre"])
def test_chunked_cg_matches_jax(criterion):
    """The default schedule against the JAX package's while_loop, as
    tests/test_torch_solvers.py holds the per-iteration form: x to 1e-9
    relative, iteration counts within 1 (dot products sum in another
    order)."""
    from devicekmc_tpu.ops.cg import cg_solve as jcg
    from devicekmc_tpu_torch.ops import cg

    assert cg.CHUNKS[0] == 1 and len(cg.CHUNKS) > 1
    A, b, x0 = _system()
    ja = jnp.asarray(A)
    ref = jcg(lambda x: ja @ x, jnp.asarray(b), x0=jnp.asarray(x0),
              diag=jnp.asarray(np.diag(A)), tol=1e-10, maxiter=5000,
              criterion=criterion)
    ta = torch.as_tensor(A)
    got = cg.cg_solve(lambda x: ta @ x, torch.as_tensor(b), x0=torch.as_tensor(x0),
                      diag=torch.as_tensor(np.diag(A).copy()), tol=1e-10, maxiter=5000,
                      criterion=criterion)
    assert abs(got.iters - int(ref.iters)) <= 1
    assert got.converged == bool(ref.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(ref.x)).max())


def test_chunked_cg_stops_on_nan(monkeypatch):
    """A matvec that turns NaN after a few iterations: the stop test fails
    on NaN, so the solve stops there unconverged, in both forms, with the
    same iterate."""
    A, b, x0 = _system()
    ta = torch.as_tensor(A)
    runs = []
    for chunks in ((1,), (1, 2, 4, 8)):
        from devicekmc_tpu_torch.ops import cg

        monkeypatch.setattr(cg, "CHUNKS", chunks)
        n = [0]

        def matvec(x):
            n[0] += 1
            return ta @ x if n[0] < 6 else torch.full_like(x, float("nan"))

        runs.append(cg.cg_solve(matvec, torch.as_tensor(b), x0=torch.as_tensor(x0),
                                tol=1e-12, maxiter=100))
    ref, got = runs
    assert not ref.converged and not got.converged
    assert got.iters == ref.iters
    assert torch.equal(torch.isnan(got.x), torch.isnan(ref.x))
    assert torch.equal(torch.nan_to_num(got.x), torch.nan_to_num(ref.x))


@pytest.mark.parametrize("shift,iters", [(0.1, 91), (1.0, 33), (0.05, 121)])
def test_chunked_cg_rate_cap(monkeypatch, shift, iters):
    """The default schedule on solves of 33-121 iterations: from the third
    chunk on, a chunk ends near the iteration that the rate of convergence
    so far predicts, so at most 8 iterations are computed past the stop
    (up to 31 with chunks of 32 alone) in at most 10 read-backs."""
    from devicekmc_tpu_torch.ops import cg

    default = cg.CHUNKS
    A, b, x0 = _system(shift=shift)
    ref, _, _ = _solve(monkeypatch, (1,), A, b, x0, tol=1e-10, maxiter=5000)
    got, reads, matvecs = _solve(monkeypatch, default, A, b, x0, tol=1e-10,
                                 maxiter=5000)
    assert got.iters == ref.iters == iters and torch.equal(got.x, ref.x)
    assert matvecs - 1 - iters <= 8 and reads <= 10
