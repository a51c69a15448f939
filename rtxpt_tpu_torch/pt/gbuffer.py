"""Primary-surface buffers of the realtime mode (counterpart of
rtxpt_tpu/pt/gbuffer.py; ExportVisibilityBuffer.hlsl, RTXDI
PathTracerSurfaceData): the `GBuffer` ReSTIR and the denoiser read, screen
projection for motion vectors, and `trace_gbuffer`, the primary pass of
the single-plane PSR-lite pipeline and of the photo-mode denoiser's
guides.

The stable-planes pipeline fills a GBuffer from the dominant plane
(models/realtime.py); `trace_gbuffer` traces it: the camera rays, then
up to `psr_depth` segments along the dominant delta branch of mirror and
smooth-glass surfaces (primary surface replacement), each a closest-hit
trace over the lanes still on a chain.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import mathutils as mu
from ..ops import traverse
from ..scene.camera import CameraData, compute_rays
from . import bsdf as B
from . import nested
from . import shading
from .shading import SurfaceData


class GBuffer(NamedTuple):
    """Primary-surface SoA over pixels (flattened)."""
    valid: torch.Tensor        # (N,) bool hit anything
    prim: torch.Tensor         # (N,) i32
    bary: torch.Tensor         # (N,2)
    t: torch.Tensor            # (N,) hit distance
    pos: torch.Tensor          # (N,3) world position
    normal: torch.Tensor       # (N,3) shading normal
    face_normal: torch.Tensor  # (N,3)
    view_z: torch.Tensor       # (N,) linear depth along camera forward
    roughness: torch.Tensor    # (N,)
    diffuse_albedo: torch.Tensor   # (N,3)
    specular_albedo: torch.Tensor  # (N,3)
    emission: torch.Tensor     # (N,3)
    motion: torch.Tensor       # (N,2) screen-space motion (prev - cur), px
    view_dir: torch.Tensor     # (N,3) unit, camera -> surface
    psr_thp: torch.Tensor      # (N,3) throughput through the delta chain
    interior: torch.Tensor     # (N,2) nested stack at the surface
    surface: SurfaceData       # full surface data for shading reuse


def project_to_screen(cam: CameraData, pos):
    """World position -> (pixel coordinates (..., 2), depth along w) for
    the given camera (u, v, w are mutually orthogonal by construction)."""
    d = pos - cam.pos
    du = mu.dot(d, cam.u, False) / torch.clamp(mu.dot(cam.u, cam.u, False),
                                               min=1e-20)
    dv = mu.dot(d, cam.v, False) / torch.clamp(mu.dot(cam.v, cam.v, False),
                                               min=1e-20)
    dw = mu.dot(d, cam.w, False) / torch.clamp(mu.dot(cam.w, cam.w, False),
                                               min=1e-20)
    safe = torch.where(torch.abs(dw) < 1e-9, 1e-9, dw)
    ndc_x = du / safe
    ndc_y = dv / safe
    px = (ndc_x + 1.0) * 0.5 * cam.viewport[0] - 0.5
    py = (1.0 - ndc_y) * 0.5 * cam.viewport[1] - 0.5
    return torch.stack([px, py], dim=-1), dw


def select(mask, a, b):
    """Per lane, `a` where `mask` else `b`, over two tensors or two
    NamedTuples of them (SurfaceData with its ShadingData and BSDFData),
    integer and bool fields included; the (N,) mask broadcasts over the
    trailing dims."""
    if isinstance(a, tuple):
        return type(a)(*(select(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def trace_gbuffer(assets, cam: CameraData, prev_cam: CameraData, px, py,
                  psr_depth: int = 2) -> GBuffer:
    """Trace the primary rays (unjittered by the caller's camera, like the
    reference's BUILD pass) and export the guide buffers and motion.

    Primary surface replacement: a pure-delta surface (mirror, smooth
    glass) is followed along its dominant delta branch for up to
    `psr_depth` more segments, so ReSTIR and the denoiser see the
    reflected or refracted surface (the single-branch core of the
    stable-planes delta tree): refraction where the surface transmits and
    F < 0.5, else reflection; a metal's branch weighs by its coloured
    Schlick term, a dielectric's by F or 1 - F."""
    n = px.shape[0]
    dev = px.device
    origin, direction = compute_rays(cam, px, py)
    hit = traverse.trace_closest(assets.accel, origin, direction)
    valid = hit.valid
    prim, bary = hit.prim, hit.bary
    surf = shading.load_surface(assets.scene, torch.clamp(prim, min=0), bary,
                                direction)
    psr_thp = torch.ones((n, 3), dtype=torch.float32, device=dev)
    interior = nested.empty(n, dev)
    emission_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    total_t = hit.t

    for _ in range(psr_depth):
        bsdf = shading.make_wavefront_bsdf(surf)
        # pure delta: no diffuse mass, zero GGX alpha on both specular
        # lobes, some specular mass
        pure_delta = valid & \
            (bsdf["p_diffuse"] + bsdf["p_diffuse_t"] < 1e-4) & \
            (bsdf["alpha"] == 0.0) & (bsdf["alpha_t"] == 0.0) & \
            (bsdf["p_specular"] + bsdf["p_specular_t"] > 0.0)
        sd = surf.sd
        cos_i = torch.sum(sd.v * sd.n, -1)
        f, cos_t = B.fresnel_dielectric(bsdf["eta"], cos_i)
        take_refr = (bsdf["p_specular_t"] > 0.0) & (f < 0.5)
        refl_dir = mu.reflect(-sd.v, sd.n)
        refr_dir = mu.safe_normalize(
            (bsdf["eta"] * cos_i - cos_t)[..., None] * sd.n
            - bsdf["eta"][..., None] * sd.v)
        new_dir = torch.where(take_refr[..., None], refr_dir, refl_dir)
        metal_w = torch.stack(
            B.fresnel_schlick3(bsdf["spec_albedo"], 1.0, cos_i), -1)
        diel_w = torch.where(
            take_refr[..., None],
            (1.0 - f)[..., None] * torch.stack(bsdf["trans_albedo"], -1),
            f[..., None] * torch.ones_like(metal_w))
        is_metal = bsdf["p_specular"] > bsdf["p_specular_t"]
        step_thp = torch.where(is_metal[..., None], metal_w, diel_w)
        step = pure_delta & (mu.luminance(step_thp) > 1e-4)

        new_origin = sd.compute_new_ray_origin(~take_refr)
        # the nested stack changes on refracting lanes of solid surfaces
        interior2 = torch.where(
            (step & take_refr & ~sd.thin_surface)[..., None],
            nested.handle_intersection(interior, sd.material_id,
                                       sd.nested_priority, sd.front_facing),
            interior)
        hit2 = traverse.trace_closest(assets.accel, new_origin, new_dir,
                                      active=step)
        emission_acc = emission_acc + torch.where(
            step[..., None], psr_thp * surf.emission, 0.0)
        surf2 = shading.load_surface(assets.scene,
                                     torch.clamp(hit2.prim, min=0),
                                     hit2.bary, new_dir)
        # lanes that stepped take the new surface; a chain that missed
        # becomes sky
        hit_ok = step & hit2.valid
        psr_thp = torch.where(step[..., None], psr_thp * step_thp, psr_thp)
        interior = torch.where(step[..., None], interior2, interior)
        valid = torch.where(step, hit_ok, valid)
        total_t = torch.where(hit_ok, total_t + hit2.t, total_t)
        direction = torch.where(step[..., None], new_dir, direction)
        surf = select(step, surf2, surf)
        prim = torch.where(step, hit2.prim, prim)
        bary = torch.where(step[..., None], hit2.bary, bary)

    bsdf = shading.make_wavefront_bsdf(surf)
    sd = surf.sd
    # denoiser guide albedos (StandardBSDF.hlsli:116-121); the specular
    # guide holds the transmission albedo so demodulation keeps glass
    d = surf.bsdf_data
    st = d.specular_transmission[..., None]
    diff_albedo = (1.0 - d.diffuse_transmission[..., None]) * (1.0 - st) \
        * d.diffuse
    spec_albedo = (1.0 - st) * d.specular + st * d.transmission
    rough = torch.where(bsdf["alpha"] < B.K_MIN_GGX_ALPHA, 0.0, d.roughness)

    # motion of static geometry: the world position reprojected with the
    # previous camera
    cur_xy = torch.stack([px.to(torch.float32), py.to(torch.float32)], -1)
    prev_xy, _ = project_to_screen(prev_cam, sd.pos)
    motion = torch.where(valid[..., None], prev_xy - cur_xy, 0.0)
    _, view_z = project_to_screen(cam, sd.pos)
    big = mu.K_MAX_RAY_TRAVEL
    v3 = valid[..., None]
    return GBuffer(
        valid=valid, prim=prim, bary=bary,
        t=torch.where(valid, total_t, big),
        pos=sd.pos, normal=sd.n, face_normal=sd.face_n,
        view_z=torch.where(valid, view_z, big), roughness=rough,
        diffuse_albedo=torch.where(v3, diff_albedo, 0.0),
        specular_albedo=torch.where(v3, spec_albedo, 0.0),
        emission=emission_acc + torch.where(v3, psr_thp * surf.emission, 0.0),
        motion=motion, view_dir=direction, psr_thp=psr_thp,
        interior=interior, surface=surf)
