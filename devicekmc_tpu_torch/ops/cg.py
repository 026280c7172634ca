"""Preconditioned conjugate gradient.

Replaces the reference's cuSPARSE/cuBLAS CG implementations
(solve_sparse_CG / solve_sparse_CG_Jacobi, src/iterative_solvers_gpu.cu:309-631)
with preconditioned CG, M = diag(A) (Jacobi) or a caller-supplied M^-1.

The loop runs on the host in chunks of iterations (:data:`CHUNKS`, each
capped by the iterations left at the rate of convergence so far), and reads
its stop condition once a chunk, not once an iteration.  Inside a chunk every
iteration tests ``active = measure > threshold`` on the device and updates
the iterate, the residual and r'z only where ``active`` holds
(``torch.where``, so an ``inf`` or ``nan`` of an iteration past the stop
cannot leak in); a stopped solve stays stopped, so the iterations after the
stop inside a chunk change nothing, and the search direction, which only the
iterations of a running solve read, needs no mask.  The chunk lengths keep
the iterations below ``maxiter``, and the chunk's ``active`` flags, summed on
the device, count its iterations.  The stopping rule is the JAX package's exactly: the iterate
returned is the first that meets the criterion, capped at ``maxiter``, so
iteration counts agree with ``devicekmc_tpu.ops.cg``, and every result is
bit-equal to a run that reads the condition every iteration (``CHUNKS =
(1,)``).  The mixed-precision solver's outer loop still reads one norm a
refinement round.

:func:`cg_solve_batched` solves B independent systems ([B, N] vectors) in
one loop, as the JAX package's vmap of its CG does: each replica has its own
stop flag, a replica that has stopped keeps its iterate, residual, r'z and
count, and the stop flags of all replicas are read once a chunk as one
vector; the chunks follow the slowest replica.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: float      # final ||r|| (or the preconditioned norm, criterion "pre")
    converged: bool      # final residual met the tolerance: the signal that
                         # chunked cold solves loop on (iteration counts are
                         # ambiguous when max_outer binds in cg_solve_mixed)
    rel0: float = float("nan")   # initial ||r0||/||b|| (cg_solve_mixed only)


#: device-to-host read-backs made by the solvers' host loops since the
#: counter was last set to 0 (one per chunk of CG iterations, two at the start
#: and one per round of the mixed-precision solver)
readbacks = 0

#: the most iterations between two reads of the stop condition, chunk after
#: chunk (the last length repeats): the first chunks are short, so that a warm
#: solve of a few iterations computes few past its stop; from the third chunk
#: on a chunk is also no longer than the iterations left at the mean rate of
#: convergence since the first read; (1,) reads every iteration
CHUNKS = (1, 2, 4, 8, 16, 32)


def cg_solve(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    diag: Optional[torch.Tensor] = None,
    tol: float = 1e-12,
    maxiter: int = 50000,
    criterion: str = "r",
    precond: Optional[Callable] = None,
    dot: Callable = torch.dot,
) -> CGResult:
    """Solve A x = b for SPD A.

    criterion: "r"   — ||r|| <= tol*||b||;
               "pre" — sqrt(r'M^-1 r) <= tol*sqrt(b'M^-1 b).
    precond: r -> M^-1 r; overrides the Jacobi ``diag`` preconditioner.
    dot: the inner product; a slab of a vector split over ranks takes the
    product summed over the ranks (``parallel.halo_superstep``), so that
    every rank reads the same stop conditions.
    """
    if x0 is None:
        x0 = torch.zeros_like(b)
    if diag is None:
        minv = torch.ones_like(b)
    else:
        minv = torch.where(diag != 0, 1.0 / diag, 1.0)
    apply_M = precond if precond is not None else (lambda r: minv * r)

    if criterion == "pre":
        ref = torch.sqrt(dot(b, apply_M(b)))
    else:
        ref = torch.sqrt(dot(b, b))
    thresh = tol * torch.where(ref > 0, ref, 1.0)
    thresh2 = thresh * thresh

    def measure2(r, rz):
        return rz if criterion == "pre" else dot(r, r)

    x = x0
    r = b - matvec(x0)
    z = apply_M(r)
    p = z
    rz = dot(r, z)
    global readbacks

    def state(ran):
        """(iterations of the chunk that ran, ||r|| or the preconditioned
        norm, criterion met, continue, threshold), computed on the device and
        read back together."""
        m2 = measure2(r, rz)
        return torch.stack([
            ran, torch.sqrt(torch.abs(m2)).to(torch.float64),
            (m2 <= thresh2).to(torch.float64), (m2 > thresh2).to(torch.float64),
            thresh.to(torch.float64)]).tolist()

    it, chunk_no = 0, 0
    read = first = None
    while it < maxiter:
        n = CHUNKS[min(chunk_no, len(CHUNKS) - 1)]
        chunk_no += 1
        if first is not None and it > first[0] and 0 < read[1] < first[1] and read[4] > 0:
            # no longer than the iterations left at the mean rate of
            # convergence since the first read: few computed past the stop
            rate = math.log(read[1] / first[1]) / (it - first[0])
            n = min(n, max(1, math.ceil(math.log(read[4] / read[1]) / rate)))
        n = min(n, maxiter - it)
        flags = []
        for _ in range(n):
            # the chunk lengths keep the iterations below maxiter, so the
            # test is the criterion alone; a stopped solve stays stopped (r
            # and rz, and with them the test, no longer change)
            active = measure2(r, rz) > thresh2
            ap = matvec(p)
            denom = dot(p, ap)
            alpha = torch.where(denom != 0, rz / denom, 0.0)
            x_n = x + alpha * p
            r_n = r - alpha * ap
            z = apply_M(r_n)
            rz_n = dot(r_n, z)
            beta = torch.where(rz != 0, rz_n / rz, 0.0)
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            rz = torch.where(active, rz_n, rz)
            # read only by the iterations of a solve that has not stopped
            p = z + beta * p
            flags.append(active)
        read = state(torch.stack(flags).sum().to(torch.float64))
        readbacks += 1
        ran = int(read[0])
        it += ran
        if first is None:
            first = (it, read[1])
        if ran < n or not read[3]:
            break
    if read is None:
        read = state(torch.zeros((), dtype=torch.float64, device=b.device))
        readbacks += 1
    return CGResult(x=x, iters=it, residual=read[1], converged=bool(read[2]))


class BatchedCGResult(NamedTuple):
    x: torch.Tensor           # [B, N]
    iters: torch.Tensor       # [B] int64, on the device
    residual: torch.Tensor    # [B] float64: final ||r||
    converged: torch.Tensor   # [B] bool: final ||r|| met the tolerance


def rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B] dot products of the rows of ``a`` and ``b`` ([B, N]).  For CPU
    tensors each row goes through ``torch.dot``, so a replica's solve is its
    single solve bit for bit; on the card one row-sum reduction serves all
    replicas (``torch.dot``'s cuBLAS reduction has no batched form of the
    same order, so there a replica may differ from its single solve in the
    last bits)."""
    if a.device.type == "cpu":
        return torch.stack([torch.dot(x, y) for x, y in zip(a, b)])
    return (a * b).sum(dim=1)


def cg_solve_batched(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    diag: torch.Tensor,
    tol: float = 1e-12,
    maxiter: int = 50000,
    active: Optional[torch.Tensor] = None,
) -> BatchedCGResult:
    """:func:`cg_solve` (criterion "r", Jacobi ``diag``) of B systems at
    once: ``matvec`` maps [B, N] to [B, N]; ``b``, ``x0``, ``diag`` are [B,
    N].  ``active`` [B] bool (default all): the replicas to solve; the others
    keep ``x0`` and count 0 iterations.  Replica b's iterate and count are
    :func:`cg_solve`'s on system b (bit for bit on the CPU, see
    :func:`rowdot`).  One read a chunk, of all replicas' flags together."""
    global readbacks
    B = b.shape[0]
    dev = b.device
    minv = torch.where(diag != 0, 1.0 / diag, 1.0)
    ref = torch.sqrt(rowdot(b, b))
    thresh = tol * torch.where(ref > 0, ref, 1.0)
    thresh2 = thresh * thresh
    act0 = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
            else active.to(device=dev, dtype=torch.bool))

    x = x0
    r = b - matvec(x0)
    z = minv * r
    p = z
    rz = rowdot(r, z)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)

    def state(ran):
        """Per replica: (iterations of the chunk that ran, ||r||, criterion
        met, continue, threshold), read back together; and ||r|| and the
        criterion as device tensors."""
        m2 = rowdot(r, r)
        norm = torch.sqrt(torch.abs(m2)).to(torch.float64)
        met = m2 <= thresh2
        return torch.stack([
            ran.to(torch.float64), norm, met.to(torch.float64),
            (act0 & (m2 > thresh2)).to(torch.float64),
            thresh.to(torch.float64)], dim=1).tolist(), norm, met

    it, chunk_no = 0, 0
    read = first = None
    while it < maxiter:
        n = CHUNKS[min(chunk_no, len(CHUNKS) - 1)]
        chunk_no += 1
        if first is not None and it > first[0]:
            # no longer than the slowest running replica's iterations left at
            # its mean rate of convergence since the first read
            left = []
            for (_, nrm, _, cont, th), f in zip(read, first[1]):
                if not cont:
                    continue
                if not (0 < nrm < f and th > 0):
                    left = None
                    break
                rate = math.log(nrm / f) / (it - first[0])
                left.append(max(1, math.ceil(math.log(th / nrm) / rate)))
            if left:
                n = min(n, max(left))
        n = min(n, maxiter - it)
        flags = []
        for _ in range(n):
            act = act0 & (rowdot(r, r) > thresh2)
            ap = matvec(p)
            denom = rowdot(p, ap)
            alpha = torch.where(denom != 0, rz / denom, 0.0)[:, None]
            x_n = x + alpha * p
            r_n = r - alpha * ap
            z = minv * r_n
            rz_n = rowdot(r_n, z)
            beta = torch.where(rz != 0, rz_n / rz, 0.0)[:, None]
            a2 = act[:, None]
            x = torch.where(a2, x_n, x)
            r = torch.where(a2, r_n, r)
            rz = torch.where(act, rz_n, rz)
            p = z + beta * p
            flags.append(act)
        ran = torch.stack(flags).sum(dim=0)
        iters = iters + ran
        read, norm, met = state(ran)
        readbacks += 1
        it += n
        if first is None:
            first = (it, [row[1] for row in read])
        if not any(row[3] for row in read):
            break
    if read is None:
        read, norm, met = state(torch.zeros(B, dtype=torch.int64, device=dev))
        readbacks += 1
    return BatchedCGResult(x=x, iters=iters, residual=norm, converged=met)


def cg_solve_mixed(
    matvec_hi: Callable,
    matvec_lo: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    diag: Optional[torch.Tensor] = None,
    tol: float = 1e-10,
    inner_tol: float = 1e-4,
    maxiter: int = 50000,
    max_outer: int = 40,
    inner_maxiter: int = 300,
    inner_precond: Optional[Callable] = None,
    inner_start: Optional[Callable] = None,
    inner_gate_rel: Optional[float] = None,
) -> CGResult:
    """Mixed-precision CG with iterative refinement: the CG iterations run
    in f32 (``matvec_lo``) on the residual scaled to O(1), and every round is
    corrected with an f64 residual (``matvec_hi``).  b, x0 and diag are f64;
    the result is f64.  On ill-conditioned conductance networks (high_G/low_G
    = 1e8) plain f32 CG leaves O(1e-2) field errors; refinement drives them to
    the f64 floor.

    ``inner_precond`` / ``inner_start``: preconditioner application and
    start-vector map of the inner solves (the A-DEF2 deflated transport CG
    needs the start vector Z E^-1 Z^T b).  With ``inner_gate_rel`` set both
    take ``(r, gate)``, gate = this round's ||r||/||b|| exceeds the threshold.

    The inner tolerance adapts: a round only needs to bring ||r|| below the
    threshold, a reduction of thresh/||r||; it asks for 0.1 of that (so the
    final residual lands about 10x below the threshold), no tighter than
    ``inner_tol`` and no looser than 0.05.  ``iters`` counts inner
    iterations; the loop also leaves after ``max_outer`` rounds, so
    ``converged`` and not the count says whether the tolerance was met."""
    global readbacks
    if x0 is None:
        x0 = torch.zeros_like(b)
    lo = torch.float32
    diag_lo = None if diag is None else diag.to(lo)

    bnorm = float(torch.sqrt(torch.dot(b, b)))
    bref = bnorm if bnorm > 0 else 1.0
    thresh = tol * bref

    x = x0
    r = b - matvec_hi(x0)
    rnorm = float(torch.sqrt(torch.dot(r, r)))
    readbacks += 2
    rel0 = rnorm / bref
    it_out = it_in = 0
    while rnorm > thresh and it_out < max_outer and it_in < maxiter:
        # scale the residual to O(1): f32 CG underflows on tiny residuals
        scale = rnorm if rnorm > 0 else 1.0
        b_in = (r / scale).to(lo)
        pre, start = inner_precond, inner_start
        if inner_gate_rel is not None:
            gate = rnorm > inner_gate_rel * bref
            if inner_precond is not None:
                pre = lambda rr: inner_precond(rr, gate)
            if inner_start is not None:
                start = lambda bb: inner_start(bb, gate)
        needed = thresh / max(rnorm, 1e-300)
        tol_round = float(torch.tensor(min(max(0.1 * needed, inner_tol), 0.05),
                                       dtype=lo))
        inner = cg_solve(
            matvec_lo, b_in,
            x0=start(b_in) if start is not None else None,
            diag=diag_lo, tol=tol_round,
            maxiter=inner_maxiter,   # bounded: f32 CG stagnates at its
                                     # precision floor; the outer rounds do
                                     # the rest
            precond=pre,
        )
        x = x + inner.x.to(b.dtype) * scale
        r = b - matvec_hi(x)
        rnorm = float(torch.sqrt(torch.dot(r, r)))
        readbacks += 1
        it_out += 1
        it_in += inner.iters
    return CGResult(x=x, iters=it_in, residual=rnorm,
                    converged=rnorm <= thresh, rel0=rel0)


def _cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Column-by-column Cholesky of a small SPD matrix (lower factor, zero
    above the diagonal), the JAX package's fori_loop formulation."""
    n = A.shape[0]
    idx = torch.arange(n, device=A.device)
    M = A.clone()
    for j in range(n):
        lrow_j = torch.where(idx < j, M[j, :], 0.0)
        s = M[:, j] - M @ lrow_j
        d = torch.sqrt(torch.clamp(s[j], min=1e-300))
        M[:, j] = torch.where(idx >= j, s / d, 0.0)
    return M


def _cholesky_solve_identity(L: torch.Tensor) -> torch.Tensor:
    """A^-1 = L^-T L^-1 by forward and backward substitution."""
    n = L.shape[0]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    Y = torch.zeros_like(L)
    for j in range(n):
        Y[j, :] = (eye[j, :] - L[j, :] @ Y) / L[j, j]
    X = torch.zeros_like(L)
    for j in range(n - 1, -1, -1):
        X[j, :] = (Y[j, :] - L[:, j] @ X) / L[j, j]
    return X


def invert_coarse(A_c: torch.Tensor) -> torch.Tensor:
    """Invert the small SPD coarse matrix in its own precision: symmetric
    diagonal scaling, a 1e-12 ridge relative to each row's scale, then
    Cholesky.  Rows with zero diagonal (empty aggregates) get a unit
    diagonal; their correction is annihilated by Z^T anyway."""
    dc = torch.sqrt(torch.abs(torch.diagonal(A_c)))
    dc = torch.where(dc > 0, dc, 1.0)
    A_cs = A_c / dc[:, None] / dc[None, :]
    A_cs = A_cs + torch.eye(A_c.shape[0], dtype=A_c.dtype, device=A_c.device) * 1e-12
    L = _cholesky_small(A_cs)
    X = _cholesky_solve_identity(L)
    return X / dc[None, :] / dc[:, None]
