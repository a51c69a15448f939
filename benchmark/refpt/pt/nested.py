"""Nested dielectrics: priority-based interior list (counterpart of
rtxpt_tpu/pt/nested.py; InteriorList.hlsli, PathTracerNestedDielectrics).

The list is an (N,2) int64 tensor of the reference's uint32 slots
(priority in the top 4 bits, material id in the low 28), kept sorted so
slot 0 is the highest-priority medium. All values are non-negative, so
int64 order equals the reference's uint32 order.
"""
from __future__ import annotations

import torch

K_NO_MATERIAL = 0xFFFFFFFF
K_MATERIAL_BITS = 28
K_PRIORITY_OFFSET = K_MATERIAL_BITS
K_MATERIAL_MASK = (1 << K_MATERIAL_BITS) - 1
K_MAX_NESTED_PRIORITY = (1 << 4) - 1


def empty(n: int, device) -> torch.Tensor:
    return torch.zeros((n, 2), dtype=torch.int64, device=device)


def make_slot(material_id, priority):
    return (priority.to(torch.int64) << K_PRIORITY_OFFSET) | (
        material_id.to(torch.int64) & K_MATERIAL_MASK)


def slot_priority(slot):
    return slot >> K_PRIORITY_OFFSET


def slot_material(slot):
    return slot & K_MATERIAL_MASK


def is_empty(slots):
    return slots[..., 0] == 0


def top_priority(slots):
    return slot_priority(slots[..., 0])


def top_material(slots):
    return torch.where(slots[..., 0] != 0, slot_material(slots[..., 0]),
                       K_NO_MATERIAL)


def next_material(slots):
    return torch.where(slots[..., 1] != 0, slot_material(slots[..., 1]),
                       K_NO_MATERIAL)


def is_true_intersection(slots, nested_priority):
    """InteriorList::isTrueIntersection (:128-132); nested_priority is the
    remapped value in [1, 15]."""
    p = nested_priority.to(torch.int64)
    return (p == 0) | (p >= top_priority(slots))


def handle_intersection(slots, material_id, nested_priority, entering):
    """InteriorList::handleIntersection (:141-213) + sortSlots."""
    p = nested_priority.to(torch.int64)
    prio = torch.where(p == 0, K_MAX_NESTED_PRIORITY, p)
    mid = material_id.to(torch.int64) & K_MATERIAL_MASK
    s0 = slots[..., 0]
    s1 = slots[..., 1]
    new = make_slot(mid, prio)
    c0 = entering & (s0 == 0)
    c1 = (~entering) & (s0 != 0) & (slot_material(s0) == mid)
    c2 = (~c0) & (~c1) & entering & (s1 == 0)
    c3 = (~c0) & (~c1) & (~c2) & (~entering) & (s1 != 0) & \
        (slot_material(s1) == mid)
    zero = torch.zeros_like(s0)
    s0 = torch.where(c0, new, torch.where(c1, zero, s0))
    s1 = torch.where(c2, new, torch.where(c3, zero, s1))
    # sort: keep the larger (higher priority) slot first
    return torch.stack([torch.maximum(s0, s1), torch.minimum(s0, s1)],
                       dim=-1)


def compute_outside_ior(slots, material_id, entering, material_iors):
    """ComputeOutsideIoR (PathTracerNestedDielectrics.hlsli:24-43)."""
    outside = top_material(slots)
    exiting_top = (~entering) & (
        outside == (material_id.to(torch.int64) & K_MATERIAL_MASK))
    outside = torch.where(exiting_top, next_material(slots), outside)
    no_mat = outside == K_NO_MATERIAL
    safe = torch.clamp(outside, max=material_iors.shape[0] - 1)
    return torch.where(no_mat, 1.0, material_iors[safe])
