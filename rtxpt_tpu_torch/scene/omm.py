"""Opacity micro-masks (counterpart of rtxpt_tpu/scene/omm.py; the
reference's OMM bake, RTXPT/OpacityMicroMap/OmmBuildQueue.cpp:149-477,
whose masks short-circuit the any-hit alpha test, Sample.hlsl:408-413).

Every triangle gets a 16-bit mask over a 4x4 barycentric grid: a bit is
set where the cell may be opaque, and clear only where the largest alpha
over the cell's whole UV footprint is below the material's cutoff, taken
from a max-filter pyramid of the base color's alpha. Traversal tests the
hit's cell (K1's OMM channel, K5, the two-level trace): a clear bit skips
a certainly transparent hit. Triangles of other than alpha-MASK materials
bake to all ones.

The bake is the reference's, bit for bit, vectorized over the triangles
of a texture and the cells that share a pyramid level (the reference
loops over triangles x cells in Python).
"""
from __future__ import annotations

import numpy as np
import torch

from .texcache import resolve_image

GRID = 4                 # 4x4 barycentric cells -> 16-bit mask
# the cells inside the barycentric triangle (the others stay clear)
_CELLS = [(ci, cj) for ci in range(GRID) for cj in range(GRID)
          if ci + cj < GRID]


def _max_pyramid(alpha: np.ndarray):
    """Conservative max-filter mip chain: level k texel (i, j) bounds the
    alpha over the 2^k x 2^k source region it covers."""
    levels = [alpha]
    cur = alpha
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h, w = cur.shape
        ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
        if (ph, pw) != (h, w):
            cur = np.pad(cur, ((0, ph - h), (0, pw - w)), mode="edge")
        cur = cur.reshape(ph // 2, 2, pw // 2, 2).max(axis=(1, 3))
        levels.append(cur)
    return levels


def _footprint_max(levels, x0, x1, y0, y1) -> np.ndarray:
    """Largest alpha over each texel box [x0,x1] x [y0,y1] (float texel
    coordinates, wrap addressing), read from the coarsest pyramid level
    whose covered index range stays within about 3 texels an axis."""
    span = np.maximum(np.maximum(x1 - x0, y1 - y0), 1.0)
    lv = np.minimum(np.ceil(np.log2(np.maximum(span / 2.0, 1.0)))
                    .astype(np.int64), len(levels) - 1)
    sx0 = np.floor(x0).astype(np.int64) >> lv
    sx1 = np.floor(np.maximum(x1 - 1e-6, x0)).astype(np.int64) >> lv
    sy0 = np.floor(y0).astype(np.int64) >> lv
    sy1 = np.floor(np.maximum(y1 - 1e-6, y0)).astype(np.int64) >> lv
    out = np.zeros(x0.shape, np.float32)
    for level in np.unique(lv):
        sel = lv == level
        a = levels[level]
        lh, lw = a.shape
        bx0, bx1, by0, by1 = sx0[sel], sx1[sel], sy0[sel], sy1[sel]
        whole = (bx1 - bx0 >= lw) | (by1 - by0 >= lh)
        m = np.zeros(bx0.shape, np.float32)
        part = ~whole
        if part.any():
            for dy in range(int((by1 - by0)[part].max()) + 1):
                for dx in range(int((bx1 - bx0)[part].max()) + 1):
                    ok = part & (by0 + dy <= by1) & (bx0 + dx <= bx1)
                    v = a[(by0 + dy) % lh, (bx0 + dx) % lw]
                    m = np.where(ok, np.maximum(m, v), m)
        out[sel] = np.where(whole, a.max(), m)
    return out


def bake_opacity_masks(host: dict) -> np.ndarray:
    """(T,) int32 16-bit masks in the scene's triangle order. host: the
    dict of SceneBuilder.finish() with its `texture_images`."""
    indices = np.asarray(host["indices"])
    masks = np.full((indices.shape[0],), 0xFFFF, np.int32)
    mats = host["materials"]
    alpha_mode = np.asarray(mats["alpha_mode"])
    images = host.get("texture_images")
    if (alpha_mode != 1).all() or not images:
        return masks
    uvs = np.asarray(host["uvs"])
    tri_mat = np.asarray(host["tri_mat"])
    base_tex = np.asarray(mats["base_tex"])
    cutoff = np.asarray(mats["alpha_cutoff"])
    masked = np.where(alpha_mode[tri_mat] == 1)[0]
    tex_of = base_tex[tri_mat[masked]]
    for tex in np.unique(tex_of):
        if tex < 0 or tex >= len(images):
            continue
        img = np.asarray(resolve_image(images[tex]))
        if img.ndim != 3 or img.shape[2] < 4:
            continue          # no alpha channel: opaque
        alpha = img[..., 3]
        if alpha.dtype == np.uint8:
            alpha = alpha.astype(np.float32) / 255.0
        levels = _max_pyramid(np.asarray(alpha, np.float32))
        h, w = levels[0].shape
        tris = masked[tex_of == tex]
        mids = tri_mat[tris]
        # the reference's scalar threshold, cutoff - 1e-3, per material
        thr = {int(m): cutoff[m] - 1e-3 for m in np.unique(mids)}
        thr = np.asarray([thr[int(m)] for m in mids])
        tri_uv = uvs[indices[tris]]                       # (n,3,2) f32
        uv0 = tri_uv[:, 0]
        e1, e2 = tri_uv[:, 1] - uv0, tri_uv[:, 2] - uv0
        m = np.zeros(tris.shape, np.int32)
        for ci, cj in _CELLS:
            # the cell's barycentric square maps to a UV parallelogram;
            # the box of its 4 corners holds the cell's footprint
            us = np.array([ci, ci + 1, ci, ci + 1]) / GRID
            vs = np.array([cj, cj, cj + 1, cj + 1]) / GRID
            pts = (uv0[:, None] + us[None, :, None] * e1[:, None]
                   + vs[None, :, None] * e2[:, None])      # (n,4,2) f64
            x0, y0 = pts[..., 0].min(1) * w, pts[..., 1].min(1) * h
            x1, y1 = pts[..., 0].max(1) * w, pts[..., 1].max(1) * h
            opaque = _footprint_max(levels, x0, x1, y0, y1) >= thr
            m |= np.where(opaque, 1 << (ci * GRID + cj), 0).astype(np.int32)
        masks[tris] = m
    return masks


def mask_bit_index(u, v):
    """Barycentric (u, v) -> the bit of their cell (K5's and K1's rule:
    truncate u * 4 and v * 4, clamp to 0..3)."""
    i = torch.clamp((u * GRID).to(torch.int32), 0, GRID - 1)
    j = torch.clamp((v * GRID).to(torch.int32), 0, GRID - 1)
    return i * GRID + j
