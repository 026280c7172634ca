"""The KMC event loop of one superstep in one launch (``csrc/kmc_events.cu``).

Replaces the device loop of the JAX package, the ``lax.while_loop`` of
``devicekmc_tpu/physics/events.py:609`` (``execute_superstep_incremental``;
not a Pallas kernel).  Given the superstep's rate table and its f64 sum
hierarchy (blocks of :data:`BLOCK` rows -> rows -> slots), the loop draws
events until the residence time reaches ``t_window`` or ``max_events`` have
fired: per event ``key, k_sel, k_time = split(key, 3)``, the hierarchical
selection, the two-site event, the conflict zeroing and the exact
recomputation of the touched sums, ``event_time = -log(u_t) / psum``.

:func:`kmc_event_loop` launches ONE persistent thread block for CUDA tensors
(no host round-trip per event) and takes the plain version
:func:`kmc_event_loop_plain`, a host loop that reads ten scalars an event,
only for CPU tensors.  Both return the new element and charge (clones of the
inputs, updated in place) and one small device tensor ``[event_time, count,
k0, k1]`` (f64), which the caller reads once per superstep; ``prob``,
``row_sums`` and ``block_sums`` are scratch and are overwritten.
``kmc_event_loop.launches`` counts kernel launches.  :func:`threefry_draws`
runs the kernel's random stream alone, to hold it against ``rng.py``.

:func:`kmc_event_loop_batched` runs B replicas' loops in ONE launch, one
block of 512 threads a replica, each with its own table, sums, element,
charge and key; the keys ([B, 2] uint32) are read from the device and the
new ones written there, and the result is one [B, 4] device tensor.  Its
plain version :func:`kmc_event_loop_batched_plain` is the plain loop replica
by replica.

Bound on the card: a chain of dependent per-event steps (the key split, three
searches, the zeroing, the sums, each behind a barrier), not bytes: an event
touches 2m+2 rows of m entries.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import rng
from ..structure import Element
from . import _build

#: rows a block of the sum hierarchy (the JAX package's ``events._BLOCK``)
BLOCK = 128
#: the kernel's block sums live in shared memory: 227 KB less the touched-row
#: list bounds the rows a table may have
MAX_SHARED_BYTES = 227 * 1024


def shared_bytes(n_blocks: int, m: int) -> int:
    """The kernel's shared memory: the block sums (f64), the touched rows
    (int32), a bit a block."""
    return 8 * n_blocks + 4 * (2 * m + 2) + 4 * -(-n_blocks // 32)


def _check_table(name, n_blocks, m):
    smem = shared_bytes(n_blocks, m)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: {n_blocks} blocks of sums need {smem} bytes of shared "
                         f"memory, more than {MAX_SHARED_BYTES}")


# event type codes (reference: src/utils.h:53-60)
VACANCY_GENERATION = 0
VACANCY_RECOMBINATION = 1
VACANCY_DIFFUSION = 2
ION_DIFFUSION = 3
NULL_EVENT = 4

_D = int(Element.DEFECT)
_OD = int(Element.OXYGEN_DEFECT)
_V = int(Element.VACANCY)
_O = int(Element.O)

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def event_type(e_i: int, e_j: int) -> int:
    if e_i == _D and e_j == _O:
        return VACANCY_GENERATION
    if e_i == _OD and e_j == _V:
        return VACANCY_RECOMBINATION
    if e_i == _V and e_j == _O:
        return VACANCY_DIFFUSION
    if e_i == _OD and e_j == _D:
        return ION_DIFFUSION
    return NULL_EVENT


def execute_event(element, charge, i: int, j: int, e_i: int, e_j: int,
                  q_i: int, q_j: int, ev: int) -> None:
    """Apply the two-site mutation of event ``ev`` in place
    (reference: KMCProcess::execute_event, src/KMCProcess.cpp:187-256):
    generation d -> Od(-2), O -> V(+2); recombination Od -> d(0), V -> O(0);
    both diffusions swap elements and charges."""
    if ev == NULL_EVENT:
        return
    if ev == VACANCY_GENERATION:
        new = (_OD, _V, -2, 2)
    elif ev == VACANCY_RECOMBINATION:
        new = (_D, _O, 0, 0)
    else:
        new = (e_j, e_i, q_j, q_i)
    element[i], element[j], charge[i], charge[j] = new


def time_draw(work_dtype, table_dtype, u_t: float, psum: float) -> float:
    """event_time = -log(u_t) / psum: the log of the draw rounded to the
    table's dtype, the division in the working dtype.  The log is taken in
    f64 and rounded, so an f32 log is the correctly rounded value on any
    host (numpy's own f32 log differs from it by up to 3 ulps, and with the
    host's vector unit) and the value the card kernel takes."""
    wd = _NP_DTYPE[work_dtype]
    lg = _NP_DTYPE[table_dtype](np.log(np.float64(u_t)))
    return float(wd(-wd(lg)) / wd(psum))


def _result(event_time, count, key, device) -> torch.Tensor:
    return torch.tensor([event_time, count, key[0], key[1]], dtype=torch.float64,
                        device=device)


def kmc_event_loop_plain(prob, row_sums, block_sums, aidx, inv, neigh_idx, rev_slot,
                         element, charge, key: rng.Key, t_window: float,
                         max_events: int, work_dtype
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: a host loop over events, the selection and the
    updates as PyTorch operations, ten scalars read back an event."""
    n_rows, m = prob.shape
    n_blocks = block_sums.shape[0]
    acc = row_sums.dtype
    aidx_l, inv_l = aidx.long(), inv.long()
    dev = prob.device
    element = element.clone()
    charge = charge.clone()
    event_time, count = 0.0, 0
    while event_time < t_window and count < max_events:
        key, k_sel, k_time = rng.split(key, 3)
        u = rng.uniform(k_sel, np.float64)

        # --- hierarchical selection over the compact rows ---
        block_cum = torch.cumsum(block_sums, dim=0)
        psum = block_cum[-1]
        target = (u * psum).reshape(1)
        blk = torch.clamp(torch.searchsorted(block_cum, target, right=True)[0],
                          max=n_blocks - 1)
        base_b = torch.where(blk > 0, block_cum[(blk - 1).clamp(min=0)], 0.0)
        rows_here = row_sums.reshape(n_blocks, BLOCK)[blk]
        row_cum = torch.cumsum(rows_here, dim=0)
        r_in = torch.clamp(
            torch.searchsorted(row_cum, target - base_b, right=True)[0], max=BLOCK - 1)
        r = torch.clamp(blk * BLOCK + r_in, max=n_rows - 1)
        base_r = torch.where(r_in > 0, row_cum[(r_in - 1).clamp(min=0)], 0.0)
        slot_cum = torch.cumsum(prob[r].to(acc), dim=0)
        s = torch.clamp(
            torch.searchsorted(slot_cum, target - base_b - base_r, right=True)[0],
            max=m - 1)
        i = aidx_l[r]
        j = neigh_idx[i, s].long()
        jc = j.clamp(min=0)
        sel = torch.stack([
            psum, prob[r, s].to(acc), r.to(acc), i.to(acc), j.to(acc),
            inv_l[jc].to(acc), element[i].to(acc), element[jc].to(acc),
            charge[i].to(acc), charge[jc].to(acc),
        ])
        psum_h, p_h, r_h, i_h, j_h, rj_h, e_i, e_j, q_i, q_j = sel.tolist()
        if not (psum_h > 0 and p_h > 0):
            event_time = float("inf")
            break
        r_h, i_h, j_h, rj_h = int(r_h), int(i_h), int(j_h), int(rj_h)
        execute_event(element, charge, i_h, j_h, int(e_i), int(e_j), int(q_i),
                      int(q_j), event_type(int(e_i), int(e_j)))

        # --- incremental conflict zeroing: rows r and rj_row, plus the
        # reverse-edge slot of i and j in every neighbouring active row ---
        rj_row = rj_h if (j_h >= 0 and rj_h >= 0) else r_h

        def rev_targets(site):
            nbrs = neigh_idx[site].long()
            slots = rev_slot[site].long()
            crow = inv_l[nbrs.clamp(min=0)]
            ok = (nbrs >= 0) & (slots >= 0) & (crow >= 0)
            return torch.where(ok, crow, r_h), torch.where(ok, slots, 0)

        ri_, ci = rev_targets(i_h)
        rj_, cj = rev_targets(j_h)
        prob[ri_, ci] = 0.0
        prob[rj_, cj] = 0.0
        prob[r_h, :] = 0.0
        prob[rj_row, :] = 0.0

        rows_touched = torch.cat([ri_, rj_, torch.tensor([r_h, rj_row], device=dev)])
        row_sums[rows_touched] = prob[rows_touched].to(acc).sum(dim=1)
        ub = rows_touched // BLOCK
        block_sums[ub] = row_sums.reshape(n_blocks, BLOCK)[ub].sum(dim=1)

        u_t = rng.uniform(k_time, _NP_DTYPE[prob.dtype])
        event_time = time_draw(work_dtype, prob.dtype, u_t, psum_h)
        count += 1
    return element, charge, _result(event_time, count, key, dev)


def _fn(symbol):
    fn = getattr(_build.load("kmc_events"), symbol)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if symbol == "dkmc_kmc_event_loop":
            fn.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_uint,
                           ctypes.c_uint, ctypes.c_double, i, i, p, p]
        elif symbol == "dkmc_kmc_event_loop_batched":
            fn.argtypes = [p, i, p, p, p, ll, p, ll, p, p, p, p, i, i, i, i, i, p,
                           ctypes.c_double, i, i, p, p, p]
        else:
            fn.argtypes = [ctypes.c_uint, ctypes.c_uint, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, dev, checks):
    for what, t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}")


def kmc_event_loop(prob, row_sums, block_sums, aidx, inv, neigh_idx, rev_slot,
                   element, charge, key: rng.Key, t_window: float, max_events: int,
                   work_dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The event loop of one superstep.

    ``prob`` [n_rows, m] (f32 or f64) the rate table, ``row_sums``
    [n_blocks * BLOCK] (f64, zero-padded) and ``block_sums`` [n_blocks] (f64)
    its sums, all three overwritten; ``aidx`` [n_rows] the site of each row,
    ``inv`` [N] the row of each site (-1 where it has none), ``neigh_idx``
    and ``rev_slot`` [N, m] (pad -1), all int32; ``element`` and ``charge``
    [N] int32; ``key`` the threefry key (k0, k1); ``work_dtype`` the dtype
    of the time division.  Returns ``(element, charge, result)``: clones of
    the inputs with the events applied, and ``[event_time, count, k0, k1]``
    as an f64 tensor on the device."""
    if prob.device.type == "cpu":
        return kmc_event_loop_plain(prob, row_sums, block_sums, aidx, inv, neigh_idx,
                                    rev_slot, element, charge, key, t_window,
                                    max_events, work_dtype)
    dev = prob.device
    if dev.type != "cuda":
        raise ValueError(f"kmc_event_loop: unsupported device {dev}")
    n_rows, m = prob.shape
    n_blocks = block_sums.shape[0]
    if prob.dtype not in _NP_DTYPE or not prob.is_contiguous():
        raise ValueError("kmc_event_loop: prob must be a contiguous f32 or f64 tensor")
    if n_rows == 0 or n_blocks != -(-n_rows // BLOCK):
        raise ValueError(f"kmc_event_loop: {n_blocks} blocks for {n_rows} rows")
    _check("kmc_event_loop", dev, (
        ("row_sums", row_sums, torch.float64, (n_blocks * BLOCK,)),
        ("block_sums", block_sums, torch.float64, (n_blocks,)),
        ("aidx", aidx, torch.int32, (n_rows,)),
        ("inv", inv, torch.int32, (element.shape[0],)),
        ("neigh_idx", neigh_idx, torch.int32, (element.shape[0], m)),
        ("rev_slot", rev_slot, torch.int32, (element.shape[0], m)),
        ("element", element, torch.int32, (element.shape[0],)),
        ("charge", charge, torch.int32, (element.shape[0],))))
    _check_table("kmc_event_loop", n_blocks, m)
    element = element.clone()
    charge = charge.clone()
    out = torch.empty(4, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("dkmc_kmc_event_loop")(
        prob.data_ptr(), int(prob.dtype == torch.float64), row_sums.data_ptr(),
        block_sums.data_ptr(), aidx.data_ptr(), inv.data_ptr(), neigh_idx.data_ptr(),
        rev_slot.data_ptr(), element.data_ptr(), charge.data_ptr(), n_rows, n_blocks, m,
        key[0], key[1], float(t_window), int(max_events),
        int(work_dtype == torch.float32), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kmc_event_loop kernel launch failed: cudaError {err}")
    kmc_event_loop.launches += 1
    return element, charge, out


kmc_event_loop.launches = 0


def kmc_event_loop_batched_plain(prob, row_sums, block_sums, aidx, inv, neigh_idx,
                                 rev_slot, element, charge, keys, t_window: float,
                                 max_events: int, work_dtype
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The plain version of :func:`kmc_event_loop_batched`:
    :func:`kmc_event_loop_plain` replica by replica, each from its key."""
    outs = []
    for b, key in enumerate(keys.tolist()):
        outs.append(kmc_event_loop_plain(
            prob[b], row_sums[b], block_sums[b], aidx if aidx.dim() == 1 else aidx[b],
            inv if inv.dim() == 1 else inv[b], neigh_idx, rev_slot, element[b], charge[b],
            (int(key[0]), int(key[1])), t_window, max_events, work_dtype))
    res = torch.stack([o[2] for o in outs])
    new_keys = res[:, 2:].to(torch.int64).to(torch.uint32)
    return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
            new_keys, res)


def kmc_event_loop_batched(prob, row_sums, block_sums, aidx, inv, neigh_idx, rev_slot,
                           element, charge, keys, t_window: float, max_events: int,
                           work_dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The event loops of B replicas' supersteps in one launch.

    ``prob`` [B, n_rows, m], ``row_sums`` [B, n_blocks * BLOCK] and
    ``block_sums`` [B, n_blocks] as :func:`kmc_event_loop` takes them, a
    replica a row; ``aidx`` [n_rows] and ``inv`` [N] shared, or [B, n_rows]
    and [B, N] one a replica (each replica's compacted rows);
    ``neigh_idx`` and ``rev_slot`` [N, m] shared; ``element`` and ``charge``
    [B, N] int32; ``keys`` [B, 2] uint32 on the device.  Returns
    ``(element, charge, keys, result)``: clones with the events applied, the
    new keys [B, 2] uint32 and ``[event_time, count, k0, k1]`` of each replica
    as one [B, 4] f64 device tensor.  Nothing is read by the host."""
    if prob.device.type == "cpu":
        return kmc_event_loop_batched_plain(prob, row_sums, block_sums, aidx, inv,
                                            neigh_idx, rev_slot, element, charge, keys,
                                            t_window, max_events, work_dtype)
    dev = prob.device
    if dev.type != "cuda":
        raise ValueError(f"kmc_event_loop_batched: unsupported device {dev}")
    if prob.dtype not in _NP_DTYPE or not prob.is_contiguous() or prob.dim() != 3:
        raise ValueError("kmc_event_loop_batched: prob must be a contiguous [B, n_rows, m] "
                         "f32 or f64 tensor")
    B, n_rows, m = prob.shape
    N = element.shape[-1]
    n_blocks = block_sums.shape[-1]
    if n_rows == 0 or n_blocks != -(-n_rows // BLOCK):
        raise ValueError(f"kmc_event_loop_batched: {n_blocks} blocks for {n_rows} rows")
    per_aidx, per_inv = aidx.dim() == 2, inv.dim() == 2
    _check("kmc_event_loop_batched", dev, (
        ("row_sums", row_sums, torch.float64, (B, n_blocks * BLOCK)),
        ("block_sums", block_sums, torch.float64, (B, n_blocks)),
        ("aidx", aidx, torch.int32, (B, n_rows) if per_aidx else (n_rows,)),
        ("inv", inv, torch.int32, (B, N) if per_inv else (N,)),
        ("neigh_idx", neigh_idx, torch.int32, (N, m)),
        ("rev_slot", rev_slot, torch.int32, (N, m)),
        ("element", element, torch.int32, (B, N)),
        ("charge", charge, torch.int32, (B, N)),
        ("keys", keys, torch.uint32, (B, 2))))
    _check_table("kmc_event_loop_batched", n_blocks, m)
    element = element.clone()
    charge = charge.clone()
    keys = keys.clone()
    out = torch.empty((B, 4), dtype=torch.float64, device=dev)
    err = _fn("dkmc_kmc_event_loop_batched")(
        prob.data_ptr(), int(prob.dtype == torch.float64), row_sums.data_ptr(),
        block_sums.data_ptr(), aidx.data_ptr(), n_rows if per_aidx else 0, inv.data_ptr(),
        N if per_inv else 0, neigh_idx.data_ptr(), rev_slot.data_ptr(), element.data_ptr(),
        charge.data_ptr(), B, N, n_rows, n_blocks, m, keys.data_ptr(), float(t_window),
        int(max_events), int(work_dtype == torch.float32), out.data_ptr(),
        _build.launch_counter(dev, "kmc_event_loop_batched"),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmc_event_loop_batched kernel launch failed: cudaError {err}")
    kmc_event_loop_batched.launches += 1
    return element, charge, keys, out


kmc_event_loop_batched.launches = 0


def threefry_draws(key: rng.Key, n: int, device="cuda"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's random stream alone, on the card: ``n`` successive
    ``key, k_sel, k_time = split(key, 3)`` from ``key``.  Returns the keys
    [n, 2] (int64 holding the uint32 words) and the uniform draws of
    (k_sel, k_time) in f64 [n, 2] and f32 [n, 2]."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("threefry_draws runs on a CUDA device")
    keys = torch.empty((n, 2), dtype=torch.int32, device=dev)
    u64 = torch.empty((n, 2), dtype=torch.float64, device=dev)
    u32 = torch.empty((n, 2), dtype=torch.float32, device=dev)
    err = _fn("dkmc_threefry_draws")(key[0], key[1], n, keys.data_ptr(), u64.data_ptr(),
                                     u32.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_draws kernel launch failed: cudaError {err}")
    return keys.long() & 0xFFFFFFFF, u64, u32
