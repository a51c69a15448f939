"""Halo exchange of row-sharded slabs (counterpart of
rtxpt_tpu/parallel/halo.py).

When a frame's rows are sharded over the ranks of a mesh
(parallel/meshutils.py), a stencil pass (the denoiser's a-trous taps,
TAA's neighbourhood, ReSTIR's temporal reprojection) needs each rank's
slab padded with its neighbours' border rows. Each rank sends its top rows
to the rank above and its bottom rows to the rank below, and receives
theirs: one point-to-point exchange per call, however many tensors it
pads. At the frame's top and bottom the pad repeats the slab's own edge
row, as the reference's `jnp.where` on `axis_index` does.
"""
from __future__ import annotations

import math

import torch


def _pack(parts) -> torch.Tensor:
    """The tensors' bytes, one after another, as one uint8 buffer."""
    return torch.cat([p.contiguous().view(torch.uint8).reshape(-1)
                      for p in parts])


def _unpack(buf: torch.Tensor, like, halo: int) -> list:
    """Split a buffer _pack made of `halo` rows of each tensor of `like`
    back into tensors of their dtypes and shapes."""
    out, o = [], 0
    for x in like:
        shape = (halo,) + tuple(x.shape[1:])
        nbytes = math.prod(shape) * x.element_size()
        out.append(buf[o:o + nbytes].clone().view(x.dtype).reshape(shape))
        o += nbytes
    return out


def exchange_row_halos(xs, halo: int, mesh) -> list:
    """Pad every (rows, W, ...) slab of `xs` (this rank's rows; the same
    rows on every tensor) with `halo` rows of the ranks above and below:
    returns [(rows + 2 * halo, W, ...)]. One exchange carries the borders
    of all of them; with one rank nothing is sent."""
    rows = xs[0].shape[0]
    if not 1 <= halo <= rows:
        raise ValueError(f"halo {halo} outside 1..{rows}, the slab's rows")
    if any(x.shape[0] != rows for x in xs):
        raise ValueError("the slabs differ in rows")
    above = below = None
    if mesh.size > 1:
        from_above, from_below = mesh.exchange(
            _pack([x[:halo] for x in xs]), _pack([x[-halo:] for x in xs]))
        if from_above is not None:
            above = _unpack(from_above, xs, halo)
        if from_below is not None:
            below = _unpack(from_below, xs, halo)
    out = []
    for i, x in enumerate(xs):
        edge = lambda r: r.expand((halo,) + tuple(x.shape[1:]))
        top = edge(x[:1]) if above is None else above[i]
        bottom = edge(x[-1:]) if below is None else below[i]
        out.append(torch.cat([top, x, bottom], 0))
    return out


def exchange_row_halo(x, halo: int, mesh):
    """Pad one (rows, W, ...) slab with `halo` rows of the neighbouring
    ranks' slabs (edge-clamped at the frame's border): (rows + 2 * halo,
    W, ...)."""
    return exchange_row_halos([x], halo, mesh)[0]
