"""Weighted reservoir sampling primitives for ReSTIR (counterpart of
rtxpt_tpu/restir/reservoir.py; the RTXDI SDK's RTXDI_DIReservoir).

A reservoir stores one light sample per pixel:
  light: i32  >= 0 local light index; -2 environment sample; -1 invalid
  uv:    (2,) area sample of a local light, oct-encoded direction for env
  w_sum: running RIS weight sum
  m:     candidate count (float: temporal reuse carries fractions)
  target: p_hat of the stored sample
The unbiased contribution weight is W = w_sum / (M * p_hat(y)).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

LIGHT_INVALID = -1
LIGHT_ENV = -2


class Reservoir(NamedTuple):
    light: torch.Tensor   # (N,) i32
    uv: torch.Tensor      # (N,2) f32
    w_sum: torch.Tensor   # (N,)
    m: torch.Tensor       # (N,)
    target: torch.Tensor  # (N,) p_hat of the stored sample

    @staticmethod
    def empty(n: int, device) -> "Reservoir":
        z = torch.zeros((n,), dtype=torch.float32, device=device)
        return Reservoir(
            light=torch.full((n,), LIGHT_INVALID, dtype=torch.int32,
                             device=device),
            uv=torch.zeros((n, 2), dtype=torch.float32, device=device),
            w_sum=z, m=z, target=z)

    def contribution_weight(self):
        """W = w_sum / (M * p_hat); 0 for an invalid or zero-target
        sample."""
        denom = self.m * self.target
        return torch.where((self.light != LIGHT_INVALID) & (denom > 0.0),
                           self.w_sum / torch.clamp(denom, min=1e-20), 0.0)


def update(r: Reservoir, light, uv, weight, target, u,
           count=1.0) -> Reservoir:
    """Stream one candidate into the reservoir (RIS update)."""
    w_sum = r.w_sum + weight
    take = (u * w_sum < weight) & (weight > 0.0)
    return Reservoir(
        light=torch.where(take, light, r.light),
        uv=torch.where(take[..., None], uv, r.uv),
        w_sum=w_sum, m=r.m + count,
        target=torch.where(take, target, r.target))


def merge(r: Reservoir, other: Reservoir, other_target_at_center,
          u) -> Reservoir:
    """Merge another reservoir (temporal / spatial reuse): the incoming
    sample is re-weighted by its target at the receiving pixel."""
    w_in = other_target_at_center * other.contribution_weight() * other.m
    return update(r, other.light, other.uv, w_in, other_target_at_center, u,
                  count=other.m)
