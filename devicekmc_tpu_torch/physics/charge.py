"""Charge-state update rule.

A vacancy carries +2 unless it has >= 2 vacancy neighbours or any metal
neighbour; an oxygen ion carries -2 unless it has a metal neighbour; all
other sites keep their charge.  Reference: Device::updateCharge
(src/potential_solver.cpp:142-229) and update_charge_gpu
(src/potential_solver_gpu.cu:10-63).

The conditions are ORs, so counting flagged neighbours over the ELL graph is
exactly the reference's early-exit adjacency walk.  One per-site flag word
(is_metal << 1 | is_vacancy) is gathered per (site, slot) pair through the
ELL-gather kernel (its plain version for CPU tensors).
:func:`update_charge_batched` applies the rule to B replicas ([B, N]
states) with one batched gather.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.ell_gather import ell_gather, ell_gather_batched
from ..state import Geometry, PhysParams, SimState, replace
from ..structure import Element

NN_COND = 2  # vacancy neighbour count that neutralises a vacancy


def _flags(geom: Geometry, elem: torch.Tensor):
    """(is_vac, the per-site flag word is_metal << 1 | is_vacancy)."""
    is_vac = elem == int(Element.VACANCY)
    return is_vac, ((geom.metal_mask_table[elem.long()].to(torch.int32) << 1)
                    | is_vac.to(torch.int32))


def _apply_rule(geom, state, is_vac, nb_flags):
    """The charge rule from the neighbours' flag words ([..., N, max_nn])."""
    elem = state.element
    valid = geom.neigh_valid
    nb_is_vac = ((nb_flags & 1) > 0) & valid
    nb_is_metal = ((nb_flags & 2) > 0) & valid

    n_vac_nn = nb_is_vac.sum(dim=-1, dtype=torch.int32)
    has_metal_nn = nb_is_metal.any(dim=-1)
    is_od = elem == int(Element.OXYGEN_DEFECT)
    vac_neutral = has_metal_nn | (n_vac_nn >= NN_COND)
    od_neutral = has_metal_nn

    charge = torch.where(
        is_vac,
        torch.where(vac_neutral, 0, 2),
        torch.where(is_od, torch.where(od_neutral, 0, -2), state.charge),
    ).to(torch.int32)

    metrics = {
        "Charged vacancies": (is_vac & ~vac_neutral).sum(dim=-1),
        "Uncharged vacancies": (is_vac & vac_neutral).sum(dim=-1),
        "Charged oxygen ions": (is_od & ~od_neutral).sum(dim=-1),
        "Uncharged oxygen ions": (is_od & od_neutral).sum(dim=-1),
    }
    return replace(state, charge=charge), metrics


def update_charge(geom: Geometry, params: PhysParams, state: SimState
                  ) -> Tuple[SimState, Dict]:
    is_vac, flags = _flags(geom, state.element)
    return _apply_rule(geom, state, is_vac, ell_gather(geom.neigh_idx, [flags])[0])


def update_charge_batched(geom: Geometry, params: PhysParams, states: SimState
                          ) -> Tuple[SimState, Dict]:
    """:func:`update_charge` of a batched state: the flags of all replicas
    gathered in one launch; metrics are [B] tensors."""
    is_vac, flags = _flags(geom, states.element)
    return _apply_rule(geom, states, is_vac,
                       ell_gather_batched(geom.neigh_idx, [flags])[0])
