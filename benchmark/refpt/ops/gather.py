"""Row gathers (counterpart of rtxpt_tpu/ops/gather_pallas.py), as plain
indexing:

  `gather_rows(table, idx)`           out[n, :] = table[idx[n], :]
  `gather_rows_interp(table, i3, w3)` out[n, :] = sum_v w3[n,v] *
                                                  table[i3[n,v], :]
  `gather_surface(...)`               the four fetches of a hit's surface
                                      (pt/shading.py `load_surface`)

Indices are clamped to the table, the semantics of the reference's XLA
gather.
"""
from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor):
    """(R, W) table, integer indices of any shape -> (*idx.shape, W)."""
    safe = torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)
    return table[safe]


def gather_rows_interp(table: torch.Tensor, idx3: torch.Tensor,
                       w3: torch.Tensor):
    """((w0*r0 + w1*r1) + w2*r2) of (N, 3) indices and weights."""
    safe = torch.clamp(idx3.to(torch.int64), 0, table.shape[0] - 1)
    acc = table[safe[:, 0]] * w3[:, 0:1]
    acc = acc + table[safe[:, 1]] * w3[:, 1:2]
    return acc + table[safe[:, 2]] * w3[:, 2:3]


def gather_surface(tri_pack, vert_pack, tri_geom_pack, mat_pack, prim,
                   bary):
    """The surface fetch of (N,) hits `prim` (-1 for a miss) with (N, 2)
    barycentrics: the triangle row, its vertices blended with the weights
    ((1 - b0) - b1, b0, b1), its geometry row and its material row ->
    (vi (N, 12), geom (N, 5), mrow (N, 46), mid (N,) i32)."""
    prim = torch.clamp(prim, min=0)
    tp = gather_rows(tri_pack, prim)
    tri, mid = tp[..., :3], tp[..., 3]
    w = torch.stack([1.0 - bary[..., 0] - bary[..., 1],
                     bary[..., 0], bary[..., 1]], dim=-1)
    vi = gather_rows_interp(vert_pack, tri, w)
    geom = gather_rows(tri_geom_pack, prim)
    mrow = gather_rows(mat_pack, mid)
    return vi, geom, mrow, mid
