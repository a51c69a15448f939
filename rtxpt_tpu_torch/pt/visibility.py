"""Visibility rays with the exact alpha test (counterpart of
rtxpt_tpu/pt/visibility.py).

The baked opacity micro-masks (scene/omm.py) let the traces skip the
certainly transparent cells of alpha-MASK triangles, but a set bit only
means "may be opaque": taken as an occluder it over-darkens partly masked
geometry (foliage, grates) against the reference's exact per-hit texture
alpha test (RTXPT/PathTracerBridgeDonut.hlsli:605-637 Bridge::AlphaTest
in the visibility RayQuery loop). The exact mode is a bounded re-queue:
a closest trace; a hit on a MASK material whose base-texture alpha is
below the cutoff is transparent, and its lane steps past the hit and
traces again, at most MAX_ALPHA_ITERS times; a lane still unresolved
then counts as occluded. Scenes without MASK materials take the plain
any-hit trace (PTConfig.exact_alpha_test, cleared by the Renderer).

The traces take no t_min: the kernels test t > 0 (ROADMAP §3).
"""
from __future__ import annotations

import torch

from ..ops import gather, traverse
from ..scene import types as ST

MAX_ALPHA_ITERS = 4


def sample_opacity(scene: ST.SceneArrays, prim, bary):
    """(alpha_mode, cutoff, opacity) of hits: the part of
    shading.load_surface the alpha test needs (the base texture's alpha,
    through the base slot's KHR_texture_transform affine, at mip 0)."""
    prim = torch.clamp(prim, min=0)
    tp = gather.gather_rows(scene.tri_pack, prim)
    mid = tp[..., 3]
    mrow = gather.gather_rows(scene.mat_pack, mid)
    alpha_mode = mrow[..., ST.MP_ALPHA_MODE].to(torch.int32)
    cutoff = mrow[..., ST.MP_ALPHA_CUTOFF]
    if scene.textures is None:
        return alpha_mode, cutoff, torch.ones_like(cutoff)
    from ..scene import textures as TX
    vp = gather.gather_rows(scene.vert_pack, tp[..., :3])    # (N,3,12)
    w = torch.stack([1.0 - bary[..., 0] - bary[..., 1], bary[..., 0],
                     bary[..., 1]], dim=-1)
    uv = torch.sum(vp[..., 10:12] * w[..., None], dim=-2)
    a = mrow[..., ST.MP_UV_AFFINE:ST.MP_UV_AFFINE + 6]
    uv = torch.stack(
        [a[..., 0] * uv[..., 0] + a[..., 1] * uv[..., 1] + a[..., 4],
         a[..., 2] * uv[..., 0] + a[..., 3] * uv[..., 1] + a[..., 5]], -1)
    tap = TX.sample_stack(scene.textures,
                          mrow[..., ST.MP_BASE_TEX].to(torch.int32), uv)
    return alpha_mode, cutoff, tap[..., 3]


def trace_visibility(assets, origins, dirs, t_max=1e30, active=None,
                     exact: bool = False, stats=None):
    """True where the segment (0, t_max) is occluded. exact: the
    alpha-aware re-queue (PTConfig.exact_alpha_test); it stops early once
    no lane is left to re-trace. stats, a dict, gets the exact mode's
    counts, summed over calls: `lanes`, the active lanes, `requeued`,
    those that stepped past a transparent hit at least once, and
    `unresolved`, those still transparent after MAX_ALPHA_ITERS traces."""
    if not exact:
        return traverse.trace_anyhit(assets.accel, origins, dirs,
                                     t_max=t_max, active=active)
    n = origins.shape[0]
    dev = origins.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    remaining = torch.as_tensor(t_max, dtype=torch.float32,
                                device=dev).expand(n)
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    requeued = torch.zeros_like(occluded)
    live = active
    o = origins
    for _ in range(MAX_ALPHA_ITERS):
        hit = traverse.trace_closest(assets.accel, o, dirs, t_max=remaining,
                                     active=live)
        got = live & hit.valid
        alpha_mode, cutoff, opacity = sample_opacity(assets.scene, hit.prim,
                                                     hit.bary)
        transparent = got & (alpha_mode == 1) & (opacity < cutoff)
        occluded = occluded | (got & ~transparent)
        live = transparent
        requeued = requeued | live
        adv = hit.t * (1.0 + 1e-4) + 1e-4
        o = torch.where(live[..., None], o + dirs * adv[..., None], o)
        remaining = torch.where(live, remaining - adv, remaining)
        live = live & (remaining > 1e-4)
        if not bool(live.any()):
            break
    if stats is not None:
        for key, m in (("lanes", active), ("requeued", requeued),
                       ("unresolved", live)):
            stats[key] = stats.get(key, 0) + int(m.sum())
    # unresolved after the bounded re-queue -> conservative occlusion
    return occluded | live
