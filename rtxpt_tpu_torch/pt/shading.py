"""Surface loading + shading frame (counterpart of rtxpt_tpu/pt/shading.py;
Bridge::loadSurface, PathTracerBridgeDonut.hlsli:364-528).

A wavefront of hits is loaded with the row-gather kernels of
ops/gather.py: the triangle row (K2, i32), the barycentric blend of the
three vertex rows (K3), the per-triangle constants (K2) and the material
row (K2) — the reference's TPU path, with plain loads instead of one-hot
matmuls. Textured materials come with the texture queue; the Renderer
refuses textured scenes until then.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import mathutils as mu
from ..ops import gather
from ..scene import types as ST

K_MAX_NESTED_PRIORITY = 14  # InteriorList.hlsli kMaxNestedPriority


class BSDFData(NamedTuple):
    """StandardBSDFData."""
    diffuse: torch.Tensor                # (N,3)
    specular: torch.Tensor               # (N,3)
    roughness: torch.Tensor              # (N,)
    metallic: torch.Tensor               # (N,)
    eta: torch.Tensor                    # (N,)
    transmission: torch.Tensor           # (N,3)
    diffuse_transmission: torch.Tensor   # (N,)
    specular_transmission: torch.Tensor  # (N,)


class ShadingData(NamedTuple):
    """ShadingData SoA (ShadingData.hlsli:20-127)."""
    pos: torch.Tensor            # (N,3) world hit position
    v: torch.Tensor              # (N,3) toward viewer (= -rayDir)
    n: torch.Tensor              # (N,3) shading normal (view side)
    t: torch.Tensor              # (N,3) tangent
    b: torch.Tensor              # (N,3) bitangent
    uv: torch.Tensor             # (N,2)
    face_n: torch.Tensor         # (N,3) triangle normal (winding side)
    vertex_n: torch.Tensor       # (N,3) interpolated normal (view side)
    front_facing: torch.Tensor   # (N,) bool
    material_id: torch.Tensor    # (N,) i32
    opacity: torch.Tensor        # (N,)
    ior: torch.Tensor            # (N,) outside IoR
    shadow_nol_fadeout: torch.Tensor
    thin_surface: torch.Tensor   # (N,) bool
    nested_priority: torch.Tensor  # (N,) i32 in [1, kMaxNestedPriority]

    def compute_new_ray_origin(self, viewside):
        """ShadingData::computeNewRayOrigin (ShadingData.hlsli:95-98)."""
        side = self.front_facing == viewside
        fn = torch.where(side[..., None], self.face_n, -self.face_n)
        return mu.compute_ray_origin(self.pos, fn)


class SurfaceData(NamedTuple):
    """Bridge::loadSurface output (PathTracerTypes.hlsli SurfaceData)."""
    sd: ShadingData
    bsdf_data: BSDFData
    emission: torch.Tensor       # (N,3)
    interior_ior: torch.Tensor   # (N,) the material's own IoR
    alpha_mode: torch.Tensor     # (N,) i32 (0 opaque / 1 mask / 2 blend)
    alpha_cutoff: torch.Tensor   # (N,)
    double_sided: torch.Tensor   # (N,) bool


def _compute_tangent_space(n, tangent_w):
    """computeTangentSpace (ShadingUtils.hlsli:110-138)."""
    txyz = tangent_w[..., :3]
    tw = tangent_w[..., 3]
    n_dot_t = torch.sum(txyz * n, dim=-1)
    non_parallel = torch.abs(n_dot_t) < 0.9999
    non_zero = torch.sum(txyz * txyz, dim=-1) > 0.0
    valid = (tw != 0.0) & non_zero & non_parallel
    t_ortho = mu.safe_normalize(txyz - n * n_dot_t[..., None])
    b_ortho = mu.cross(n, t_ortho) * tw[..., None]
    t_fallback = mu.safe_normalize(mu.perp_stark(n))
    b_fallback = mu.cross(n, t_fallback)
    t = torch.where(valid[..., None], t_ortho, t_fallback)
    b = torch.where(valid[..., None], b_ortho, b_fallback)
    return t, b


def _adjust_shading_normal(n, v, oriented_face_n, tangent_w):
    """adjustShadingNormal (ShadingUtils.hlsli:144-165)."""
    ng = oriented_face_n
    sign_n = torch.where(torch.sum(n * ng, dim=-1) >= 0.0, 1.0, -1.0)
    ns = sign_n[..., None] * n
    cos_theta = torch.sum(v * ns, dim=-1)
    t_blend = mu.saturate(cos_theta * (1.0 / 0.1))
    blended = sign_n[..., None] * mu.safe_normalize(
        mu.lerp(ng, ns, t_blend[..., None]))
    n2 = torch.where((cos_theta <= 0.1)[..., None], blended, n)
    t, b = _compute_tangent_space(n2, tangent_w)
    return n2, t, b


def load_surface(scene: ST.SceneArrays, prim, bary, ray_dir,
                 outside_ior=None) -> SurfaceData:
    """Gather + interpolate surface attributes for a wavefront of hits and
    build StandardBSDFData like the bridge. prim (N,) triangle ids (miss
    lanes are masked downstream); bary (N,2); ray_dir (N,3)."""
    prim = torch.clamp(prim, min=0)
    tp = gather.gather_rows(scene.tri_pack, prim)              # (N,4) i32
    tri = tp[..., :3]
    mid = tp[..., 3]
    w = torch.stack([1.0 - bary[..., 0] - bary[..., 1],
                     bary[..., 0], bary[..., 1]], dim=-1)      # (N,3)
    vi = gather.gather_rows_interp(scene.vert_pack, tri.contiguous(), w)
    geom = gather.gather_rows(scene.tri_geom_pack, prim)       # (N,5)
    face_n = geom[..., 0:3]

    pos = vi[..., 0:3]
    nrm = mu.safe_normalize(vi[..., 3:6])
    tan = vi[..., 6:10]
    uv = vi[..., 10:12]

    v = -ray_dir
    front_facing = torch.sum(face_n * v, dim=-1) >= 0.0
    ff = front_facing[..., None]
    # vertexN oriented to the view side (BridgeDonut:404); all surfaces
    # double-sided: flip the shading normal for back hits (:535)
    vertex_n = torch.where(ff, nrm, -nrm)
    oriented_ng = torch.where(ff, face_n, -face_n)
    n, t, b = _adjust_shading_normal(vertex_n, v, oriented_ng, tan)

    # material fetch + conversion (BridgeDonut:444-521)
    mrow = gather.gather_rows(scene.mat_pack, mid)             # (N,46)
    base_color = mrow[..., ST.MP_BASE:ST.MP_BASE + 3]
    metalness = mrow[..., ST.MP_METAL]
    roughness = mrow[..., ST.MP_ROUGH]
    mat_ior = mrow[..., ST.MP_IOR]
    transmission = mrow[..., ST.MP_TRANS]
    diffuse_transmission = mrow[..., ST.MP_DIFF_TRANS]
    thin = mrow[..., ST.MP_THIN] != 0.0
    emissive = mrow[..., ST.MP_EMISSIVE:ST.MP_EMISSIVE + 3]
    shadow_fade = mrow[..., ST.MP_SHADOW_FADE]
    nested_priority = torch.clamp(
        1 + mrow[..., ST.MP_NESTED_PRIO].to(torch.int32),
        max=K_MAX_NESTED_PRIORITY)

    spec_trans = transmission * (1.0 - metalness)
    diff_trans = diffuse_transmission * (1.0 - metalness)
    f = (mat_ior - 1.0) / (mat_ior + 1.0)
    f0 = f * f * mrow[..., ST.MP_SPECULAR_FACTOR]   # KHR_materials_specular
    diffuse = base_color * (1.0 - metalness)[..., None]
    specular = mu.lerp(f0[..., None] * torch.ones_like(base_color),
                       base_color, metalness[..., None])
    if outside_ior is None:
        outside_ior = torch.ones_like(mat_ior)
    eta = torch.where(front_facing, outside_ior / mat_ior,
                      mat_ior / outside_ior)
    data = BSDFData(
        diffuse=diffuse, specular=specular, roughness=roughness,
        metallic=metalness, eta=eta, transmission=base_color,
        diffuse_transmission=diff_trans, specular_transmission=spec_trans)
    # single-sided emission (BridgeDonut:517)
    emission = torch.where(ff, emissive, 0.0)
    sd = ShadingData(
        pos=pos, v=v, n=n, t=t, b=b, uv=uv, face_n=face_n,
        vertex_n=vertex_n, front_facing=front_facing, material_id=mid,
        opacity=torch.ones_like(roughness), ior=outside_ior,
        shadow_nol_fadeout=shadow_fade, thin_surface=thin,
        nested_priority=nested_priority)
    return SurfaceData(
        sd=sd, bsdf_data=data, emission=emission, interior_ior=mat_ior,
        alpha_mode=mrow[..., ST.MP_ALPHA_MODE].to(torch.int32),
        alpha_cutoff=mrow[..., ST.MP_ALPHA_CUTOFF],
        double_sided=mrow[..., ST.MP_DOUBLE_SIDED] != 0.0)


def update_outside_ior(surface: SurfaceData, outside_ior) -> SurfaceData:
    """Bridge::updateOutsideIoR (BridgeDonut:530-536): recompute eta after
    the nested-dielectric resolve changed the outside IoR."""
    sd = surface.sd._replace(ior=outside_ior)
    eta = torch.where(sd.front_facing, outside_ior / surface.interior_ior,
                      surface.interior_ior / outside_ior)
    return surface._replace(sd=sd,
                            bsdf_data=surface.bsdf_data._replace(eta=eta))
