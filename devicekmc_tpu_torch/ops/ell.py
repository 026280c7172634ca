"""Padded-neighbour (ELL) sparse matrix-vector product.

The conductance graph is an ELL matrix: ``neigh_idx[N, max_nn]`` (pad -1)
with per-edge values ``vals[N, max_nn]`` and a diagonal.  Pads carry value 0,
so the clamped pad index needs no mask in the accumulation.
"""

from __future__ import annotations

import torch


def safe_index(neigh_idx: torch.Tensor) -> torch.Tensor:
    """``max(neigh_idx, 0)`` as int64, the index form torch gathers take;
    callers that run many products build it once."""
    return neigh_idx.clamp(min=0).long()


def ell_matvec(diag: torch.Tensor, vals: torch.Tensor, safe_idx: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A = diag + off-diagonal ELL values; ``safe_idx`` is
    :func:`safe_index` of the neighbour array.  With a leading replica axis
    (``diag``, ``x`` [B, N], ``vals`` [B, N, max_nn]) each replica's product
    is its own, row by row the same arithmetic."""
    return diag * x + (vals * x[..., safe_idx]).sum(dim=-1)
