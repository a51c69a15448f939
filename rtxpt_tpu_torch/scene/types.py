"""Flat SoA scene tables (counterpart of rtxpt_tpu/scene/types.py).

The reference also packs bf16 one-hot "gather planes" for the TPU's
matrix unit; on the GPU a row gather is a plain load, so the port keeps
only the plain f32/i32 packed tables that `ops/gather.py` reads.
Packing runs host-side in numpy; `SceneArrays` holds the device copies.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# mat_pack column layout (all f32; texture ids / modes as exact floats)
MP_BASE = 0            # 0:3 base_color
MP_METAL = 3
MP_ROUGH = 4
MP_IOR = 5
MP_TRANS = 6
MP_DIFF_TRANS = 7
MP_EMISSIVE = 8        # 8:11
MP_THIN = 11
MP_NESTED_PRIO = 12
MP_SHADOW_FADE = 13
MP_BASE_TEX = 14
MP_EMISSIVE_TEX = 15
MP_MR_TEX = 16
MP_NORMAL_TEX = 17
MP_ALPHA_MODE = 18
MP_ALPHA_CUTOFF = 19
MP_DOUBLE_SIDED = 20
MP_UV_AFFINE = 21      # 21:45 — 4 slots x 6 affine coefficients
MP_SPECULAR_FACTOR = 45
MP_COLS = 46


@dataclasses.dataclass
class SceneArrays:
    """The scene's device tables (world space)."""
    positions: torch.Tensor      # (V,3) f32
    indices: torch.Tensor        # (T,3) i32
    vert_pack: torch.Tensor      # (V,12) f32 pos3 nrm3 tan4 uv2
    tri_pack: torch.Tensor       # (T,4) i32 idx0..2, material
    tri_geom_pack: torch.Tensor  # (T,5) f32 face_n3, raw uv_area, area
    mat_pack: torch.Tensor       # (M,46) f32, layout above
    mat_ior: torch.Tensor        # (M,) f32 interior IoR (nested resolve)
    volume_absorption: torch.Tensor  # (M,3) f32 Beer-Lambert sigma_a

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


def pack_tables(positions, normals, tangents, uvs, indices, tri_mat,
                materials: dict):
    """(vert_pack, tri_pack, tri_geom_pack, mat_pack) from the host
    arrays of SceneBuilder.finish() (numpy)."""
    vert_pack = np.concatenate(
        [positions, normals, tangents, uvs], axis=-1)        # (V,12)
    tri_pack = np.concatenate(
        [indices, tri_mat[:, None]], axis=-1)                # (T,4)
    tri_geom = tri_geom_pack(positions, uvs, indices)
    m = materials
    f32 = lambda a: np.asarray(a).astype(np.float32)[:, None]
    mat_pack = np.concatenate([
        np.asarray(m["base_color"]),
        f32(m["metalness"]), f32(m["roughness"]), f32(m["ior"]),
        f32(m["transmission"]), f32(m["diffuse_transmission"]),
        np.asarray(m["emissive"]),
        f32(m["thin_surface"]), f32(m["nested_priority"]),
        f32(m["shadow_nol_fadeout"]),
        f32(m["base_tex"]), f32(m["emissive_tex"]),
        f32(m["metal_rough_tex"]), f32(m["normal_tex"]),
        f32(m["alpha_mode"]), f32(m["alpha_cutoff"]),
        f32(m["double_sided"]),
        _effective_uv_affine(m),
        f32(m["specular_factor"]),
    ], axis=-1)                                              # (M,46)
    return vert_pack, tri_pack, tri_geom, mat_pack


def tri_geom_pack(positions, uvs, indices):
    """(T,5) per-triangle constants [face_n(3), raw uv_area, world_area]:
    what load_surface needs beyond barycentric-blendable attributes."""
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    cr = np.cross(p1 - p0, p2 - p0)
    ln = np.linalg.norm(cr, axis=-1, keepdims=True)
    fn = cr / np.maximum(ln, 1e-20)
    world_area = 0.5 * ln[:, 0]
    u0 = uvs[indices[:, 0]]
    e1 = uvs[indices[:, 1]] - u0
    e2 = uvs[indices[:, 2]] - u0
    uv_area = 0.5 * np.abs(e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0])
    return np.concatenate([fn, uv_area[:, None], world_area[:, None]],
                          axis=-1)


def _effective_uv_affine(m: dict):
    """(M,24): per-slot affine composed with the legacy single
    offset+scale (uv' = A_slot @ (S_legacy uv + o_legacy) + t_slot)."""
    a = np.asarray(m["uv_affine"]).reshape(-1, 4, 6)
    s = np.asarray(m["uv_scale"])[:, None, :]
    o = np.asarray(m["uv_offset"])[:, None, :]
    m00 = a[..., 0] * s[..., 0]
    m01 = a[..., 1] * s[..., 1]
    m10 = a[..., 2] * s[..., 0]
    m11 = a[..., 3] * s[..., 1]
    tx = a[..., 0] * o[..., 0] + a[..., 1] * o[..., 1] + a[..., 4]
    ty = a[..., 2] * o[..., 0] + a[..., 3] * o[..., 1] + a[..., 5]
    return np.stack([m00, m01, m10, m11, tx, ty], axis=-1).reshape(-1, 24)


def default_material_table(n: int = 1) -> dict:
    """Host-side (numpy) dict of default material fields, length n."""
    return dict(
        base_color=np.full((n, 3), 0.8, np.float32),
        metalness=np.zeros((n,), np.float32),
        roughness=np.full((n,), 0.5, np.float32),
        ior=np.full((n,), 1.5, np.float32),
        transmission=np.zeros((n,), np.float32),
        diffuse_transmission=np.zeros((n,), np.float32),
        emissive=np.zeros((n, 3), np.float32),
        thin_surface=np.zeros((n,), bool),
        nested_priority=np.zeros((n,), np.int32),
        volume_absorption=np.zeros((n, 3), np.float32),
        excluded_from_nee=np.zeros((n,), bool),
        shadow_nol_fadeout=np.zeros((n,), np.float32),
        base_tex=np.full((n,), -1, np.int32),
        emissive_tex=np.full((n,), -1, np.int32),
        metal_rough_tex=np.full((n,), -1, np.int32),
        normal_tex=np.full((n,), -1, np.int32),
        transmission_tex=np.full((n,), -1, np.int32),
        alpha_mode=np.zeros((n,), np.int32),
        alpha_cutoff=np.full((n,), 0.5, np.float32),
        double_sided=np.ones((n,), bool),
        uv_offset=np.zeros((n, 2), np.float32),
        uv_scale=np.ones((n, 2), np.float32),
        uv_affine=np.tile(np.asarray([1, 0, 0, 1, 0, 0] * 4,
                                     np.float32), (n, 1)),
        specular_factor=np.ones((n,), np.float32),
    )
