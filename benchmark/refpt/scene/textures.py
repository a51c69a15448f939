"""Texture system (counterpart of rtxpt_tpu/scene/textures.py): host
decode -> device texel pool -> sampled fetch.

  - donut TextureCache (sRGB handling, mips, bindless registration) ->
    float32 decode and a box-filtered mip chain, packed into one flat
    (P, 4) texel pool, bit for bit the reference's (numpy);
  - the bindless texture table -> per-texture (offset, size) tables;
  - ray-cone texture LOD (Bridge::createTextureSampler,
    PathTracerBridgeDonut.hlsli:337-352) -> a UV-space lambda; the
    per-texture log2(size) term is added inside the fetch.

A trilinear tap is 8 texel rows at computed flat offsets, gathered by
ops/gather.py `gather_rows` (row width 4); the blend stays tensor code in the reference's operation order.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import mathutils as mu
from ..ops import gather
from .types import TextureStack


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _resize_bilinear(arr: np.ndarray, size: int) -> np.ndarray:
    """Float32 bilinear resample to (size, size, C)."""
    h, w = arr.shape[:2]
    if h == size and w == size:
        return arr
    ys = (np.arange(size, dtype=np.float32) + 0.5) * (h / size) - 0.5
    xs = (np.arange(size, dtype=np.float32) + 0.5) * (w / size) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = arr[y0][:, x0] * (1 - fx) + arr[y0][:, x1] * fx
    b = arr[y1][:, x0] * (1 - fx) + arr[y1][:, x1] * fx
    return (a * (1 - fy) + b * fy).astype(np.float32)


def _to_float_rgba(img: np.ndarray, srgb: bool) -> np.ndarray:
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
    if srgb:
        # sRGB -> linear on the color channels only (alpha stays linear),
        # before the mips so that filtering happens in linear space
        arr = np.concatenate([arr[..., :3] ** 2.2, arr[..., 3:4]], -1)
    return arr


def build_texture_stack(images: List[np.ndarray],
                        srgb: Optional[Sequence[bool]] = None,
                        max_size: int = 1024, size: Optional[int] = None,
                        device="cuda") -> Optional[TextureStack]:
    """images: (h,w,1|3|4) uint8/uint16/float arrays. Each is resampled to its own power-of-two size
    (capped at max_size), mipped down to 1x1 and packed into the flat
    texel pool on `device`. srgb: per texture, True for color maps
    (sRGB -> linear on integer decode), False for data maps; all True by
    default."""
    if not images:
        return None
    if size is not None:
        max_size = size
    k = len(images)
    if srgb is None:
        srgb = [True] * k
    pool_parts: List[np.ndarray] = []
    l_max = int(math.log2(max_size)) + 1
    mip_offset = np.zeros((k, l_max), np.int64)
    mip_size = np.zeros((k, l_max), np.int32)
    n_mips = np.zeros((k,), np.int32)
    cursor = 0
    for ti, img in enumerate(images):
        # the sRGB decode applies to integer images only; float inputs
        # are already linear
        arr = _to_float_rgba(img, bool(srgb[ti]) and np.issubdtype(
            np.asarray(img).dtype, np.integer))
        s = max(min(max_size, _next_pow2(max(arr.shape[0], arr.shape[1]))),
                1)
        m = _resize_bilinear(arr, s)
        level = 0
        while True:
            mip_offset[ti, level] = cursor
            mip_size[ti, level] = m.shape[0]
            pool_parts.append(m.reshape(-1, 4))
            cursor += m.shape[0] * m.shape[0]
            level += 1
            if m.shape[0] == 1:
                break
            m = 0.25 * (m[0::2, 0::2] + m[0::2, 1::2]
                        + m[1::2, 0::2] + m[1::2, 1::2])
        n_mips[ti] = level
    if cursor >= 2 ** 31:
        raise ValueError(f"texel pool of {cursor} rows: offsets are int32")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return TextureStack(pool=t(np.concatenate(pool_parts, axis=0)),
                        mip_offset=t(mip_offset.astype(np.int32)),
                        mip_size=t(mip_size), n_mips=t(n_mips))


def sample_stack(stack: TextureStack, tex, uv, lod=None):
    """Trilinear fetch from the texel pool: tex (N,) slot (-1: white),
    uv (N,2) wrapped, lod (N,) UV-space log2 footprint (the per-texture
    log2(size) term is added here) or None for mip 0 -> (N,4)."""
    slot = torch.clamp(tex, min=0).long()
    nm = stack.n_mips[slot]
    size0 = stack.mip_size[slot, 0].to(torch.float32)
    if lod is None:
        lf = torch.zeros(slot.shape, dtype=torch.float32, device=uv.device)
    else:
        lf = lod + torch.log2(torch.clamp(size0, min=1.0))
    lf = torch.minimum(torch.clamp(lf, min=0.0), (nm - 1).to(torch.float32))
    l0 = lf.to(torch.int32)

    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])

    def fetch(level):
        level = level.long()
        off = stack.mip_offset[slot, level]
        s = stack.mip_size[slot, level]
        sf = s.to(torch.float32)
        x = u * sf - 0.5
        y = v * sf - 0.5
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        # floor-mod, as jnp's % (torch.fmod truncates)
        x0 = torch.remainder(x0, s)
        y0 = torch.remainder(y0, s)
        x1 = torch.remainder(x0 + 1, s)
        y1 = torch.remainder(y0 + 1, s)
        base = off + y0 * s
        base1 = off + y1 * s
        rows = gather.gather_rows(
            stack.pool, torch.stack([base + x0, base + x1, base1 + x0,
                                     base1 + x1], -1))       # (N,4,4)
        a = rows[..., 0, :] * (1 - fx) + rows[..., 1, :] * fx
        b = rows[..., 2, :] * (1 - fx) + rows[..., 3, :] * fx
        return a * (1 - fy) + b * fy

    out = fetch(l0)
    if lod is not None:
        l1 = torch.minimum(l0 + 1, nm - 1)
        frac = (lf - l0.to(torch.float32))[..., None]
        out = out * (1 - frac) + fetch(l1) * frac
    return torch.where((tex >= 0)[..., None], out, 1.0)


def ray_cone_lod(cone_width, cos_theta, uv_area, world_area):
    """UV-space texture lambda from ray cones ("Improved Shader and
    Texture LOD Using Ray Cones"; TexLODHelpers computeRayConeTriangleLOD):
    the cone's footprint over the projected area. sample_stack adds the
    per-texture log2(size)."""
    ta = torch.sqrt(torch.clamp(uv_area, min=1e-20)
                    / torch.clamp(world_area, min=1e-20))
    footprint = cone_width * ta / torch.clamp(torch.abs(cos_theta), min=0.05)
    return torch.log2(torch.clamp(footprint, min=1e-10))


def perturb_normal(n, t, b, normal_sample):
    """A tangent-space normal-map sample applied to the frame (donut
    MaterialSample shadingNormal path)."""
    ts = normal_sample[..., :3] * 2.0 - 1.0
    out = ts[..., 0:1] * t + ts[..., 1:2] * b + ts[..., 2:3] * n
    return mu.safe_normalize(out, n)
