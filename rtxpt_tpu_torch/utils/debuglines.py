"""Debug line rendering (counterpart of rtxpt_tpu/utils/debuglines.py;
RTXPT/DebugLines.hlsl and ShaderDebug.hlsli's DebugDrawLine /
DebugDrawAABB: a device line buffer appended from shaders and
rasterized over the frame).

The buffer is a fixed-capacity SoA of tensors; emitters return new
buffers, and the overlay samples each segment at fixed parameters,
projects the samples and scatters their colours into the image with a
max blend (no rasterizer). Uses, as in the reference:
  * the pick-pixel path: one pixel's bounce chain, one segment a vertex
    (Sample.cpp pick-pixel + DebugLinesPass);
  * AABB wireframes (BVH or cluster boxes, DebugDrawAABB).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .debugprint import mirror_step, pixel_paths

CAPACITY = 4096


class LineBuffer(NamedTuple):
    """Fixed-capacity line SoA (DebugLines.hlsl t_DebugLines)."""
    a: torch.Tensor        # (K,3) world start
    b: torch.Tensor        # (K,3) world end
    color: torch.Tensor    # (K,3)
    count: torch.Tensor    # () i64 valid prefix

    @staticmethod
    def empty(capacity: int = CAPACITY, device="cuda") -> "LineBuffer":
        z = lambda: torch.zeros((capacity, 3), dtype=torch.float32,
                                device=device)
        return LineBuffer(z(), z(), z(),
                          torch.zeros((), dtype=torch.int64, device=device))


def add_lines(buf: LineBuffer, a, b, color) -> LineBuffer:
    """Append a batch of segments (those past the capacity are dropped)."""
    dev = buf.a.device
    f = lambda v: torch.atleast_2d(torch.as_tensor(v, dtype=torch.float32,
                                                   device=dev))
    a, b = f(a), f(b)
    color = torch.as_tensor(color, dtype=torch.float32,
                            device=dev).expand(a.shape)
    k, cap = a.shape[0], buf.a.shape[0]
    idx = buf.count + torch.arange(k, device=dev)
    ok = idx < cap
    idx = torch.where(ok, idx, cap - 1)

    def put(arr, val):
        out = arr.clone()
        out[idx] = torch.where(ok[:, None], val, arr[idx])
        return out
    return LineBuffer(put(buf.a, a), put(buf.b, b), put(buf.color, color),
                      torch.clamp(buf.count + k, max=cap))


def add_aabb(buf: LineBuffer, lo, hi, color=(1.0, 0.8, 0.1)) -> LineBuffer:
    """12-edge wireframe of an axis-aligned box (DebugDrawAABB)."""
    c = np.stack([np.asarray(lo, np.float32), np.asarray(hi, np.float32)])
    corners = np.asarray([[c[i][0], c[j][1], c[k][2]]
                          for i in range(2) for j in range(2)
                          for k in range(2)], np.float32)
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    a = corners[[e[0] for e in edges]]
    b = corners[[e[1] for e in edges]]
    return add_lines(buf, a, b, color)


def lines_for_path(assets, cam, x: int, y: int, *, max_bounces: int = 6,
                   buf: LineBuffer = None) -> LineBuffer:
    """Trace pixel (x, y)'s deterministic bounce chain (1-lane traces and
    surface fetches) and emit one segment per path vertex: the reference's
    pick-pixel path visualization (DebugLinesPass fed from the path
    tracer's DebugDrawLine calls). The colour fades from white to red
    with depth; a miss is drawn dim blue to 25 units out."""
    from ..ops import traverse
    from ..pt import shading

    dev = assets.scene.positions.device
    if buf is None:
        buf = LineBuffer.empty(device=dev)
    p = pixel_paths(cam, x, y, max_bounces, dev)
    origin, direction, active = p.origin, p.direction, p.active
    miss_col = torch.tensor([[0.2, 0.3, 0.8]], device=dev)
    for depth in range(max_bounces + 1):
        hit = traverse.trace_closest(assets.accel, origin, direction,
                                     active=active)
        t = torch.where(hit.valid, hit.t, 25.0)
        end = origin + direction * t[:, None]
        fade = depth / max(max_bounces, 1)
        col = torch.where(hit.valid[:, None],
                          torch.tensor([[1.0, 1.0 - fade, 1.0 - fade]],
                                       device=dev), miss_col)
        a1 = active[:, None]
        buf = add_lines(buf, torch.where(a1, origin, 0.0),
                        torch.where(a1, end, 0.0),
                        torch.where(a1, col, 0.0))
        if depth == max_bounces:
            break
        # the mirror continuation about the shading normal: the glyph
        # shows the geometry chain, not a stochastic path
        surf = shading.load_surface(assets.scene, torch.clamp(hit.prim, min=0),
                                    hit.bary, direction)
        origin, direction = mirror_step(surf, direction)
        active = active & hit.valid
    return buf


def rasterize_overlay(image, buf: LineBuffer, cam, *,
                      samples_per_line: int = 128):
    """Paint the line buffer over an (H,W,3) image: samples along each
    segment, projected to pixels, scattered with a max blend and no depth
    test (the reference's line draw call). Off-screen samples go to pixel
    (0, 0) with colour 0; a max does not depend on the order of the
    scatter."""
    from ..pt.gbuffer import project_to_screen

    h, w = image.shape[0], image.shape[1]
    dev = image.device
    k = buf.a.shape[0]
    # i / (S - 1) in float32, as the reference's linspace computes it
    ts = torch.as_tensor(np.arange(samples_per_line, dtype=np.float32)
                         / np.float32(max(samples_per_line - 1, 1)),
                         device=dev)
    pts = buf.a[:, None, :] + (buf.b - buf.a)[:, None, :] * \
        ts[None, :, None]                                # (K,S,3)
    xy, z = project_to_screen(cam, pts.reshape(-1, 3))
    xi = torch.round(xy[:, 0]).to(torch.int64)
    yi = torch.round(xy[:, 1]).to(torch.int64)
    live = (torch.arange(k, device=dev)[:, None] < buf.count) \
        .expand(k, samples_per_line).reshape(-1)
    ok = live & (z.reshape(-1) > 0.0) & (xi >= 0) & (xi < w) & \
        (yi >= 0) & (yi < h)
    flat = torch.where(ok, yi * w + xi, 0)
    col = buf.color.repeat_interleave(samples_per_line, dim=0)
    col = torch.where(ok[:, None], col, 0.0)
    out = image.reshape(h * w, 3).to(torch.float32).clone()
    out.scatter_reduce_(0, flat[:, None].expand(-1, 3), col, "amax",
                        include_self=True)
    return out.reshape(h, w, 3)
