"""Fixed-size stream compaction with the semantics of
``jnp.nonzero(mask, size=size, fill_value=fill_value)``."""

from __future__ import annotations

from typing import Tuple

import torch


def nonzero_fixed(mask: torch.Tensor, size: int, fill_value: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of True entries (ascending) truncated or padded with
    ``fill_value`` to ``size`` (int32), and the true count (0-d int32
    tensor, not truncated)."""
    idx = torch.nonzero(mask).reshape(-1).to(torch.int32)
    count = torch.tensor(idx.shape[0], dtype=torch.int32, device=mask.device)
    out = torch.full((size,), fill_value, dtype=torch.int32, device=mask.device)
    k = min(size, idx.shape[0])
    out[:k] = idx[:k]
    return out, count


def nonzero_fixed_batched(mask: torch.Tensor, size: int, fill_value: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nonzero_fixed` of each row of ``mask`` [B, N], computed on the
    device without a host read: the indices [B, size] (int32) and the true
    counts [B] (int32).  A True entry lands at its rank among the row's True
    entries; ranks past ``size`` go to a dropped column."""
    B, n = mask.shape
    rank = torch.cumsum(mask, dim=1) - 1
    col = torch.where(mask & (rank < size), rank, size)
    out = torch.full((B, size + 1), fill_value, dtype=torch.int32, device=mask.device)
    src = torch.arange(n, dtype=torch.int32, device=mask.device).expand(B, n)
    out.scatter_(1, col, src)
    return out[:, :size].contiguous(), mask.sum(dim=1, dtype=torch.int32)
