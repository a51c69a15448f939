"""Build the port's render assets from the reference package's tables.

The parity tests run both packages on identical tables: the reference
builds its SceneArrays packs, DenseMT planes, EnvMap and LightTable, and
these functions turn their fields (as numpy arrays) into the port's
device tables. The port's own host build is checked against the same
tables separately. Nothing here imports the reference package: every
input is read with ``numpy.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.mt_dense import DenseMT
from .pt.integrator import RenderAssets
from .scene.envmap import EnvMap
from .scene.lights import LightTable
from .scene.types import SceneArrays


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def scene_from_arrays(*, positions, indices, vert_pack, tri_pack,
                      tri_geom_pack, mat_pack, material_ior,
                      volume_absorption, device="cpu") -> SceneArrays:
    f32, i32 = torch.float32, torch.int32
    return SceneArrays(
        positions=_t(positions, f32, device), indices=_t(indices, i32, device),
        vert_pack=_t(vert_pack, f32, device),
        tri_pack=_t(tri_pack, i32, device),
        tri_geom_pack=_t(tri_geom_pack, f32, device),
        mat_pack=_t(mat_pack, f32, device),
        mat_ior=_t(material_ior, f32, device),
        volume_absorption=_t(volume_absorption, f32, device))


def dense_from_arrays(*, aabb, tri9, center, num_clusters: int,
                      device="cpu") -> DenseMT:
    f32 = torch.float32
    return DenseMT(aabb=_t(aabb, f32, device), tri9=_t(tri9, f32, device),
                   center=_t(center, f32, device),
                   num_clusters=int(num_clusters))


def env_from_arrays(*, radiance_quad, alias_pack, height: int, width: int,
                    intensity=1.0, enabled=True, device="cpu") -> EnvMap:
    return EnvMap(radiance_quad=_t(radiance_quad, torch.float32, device),
                  alias_pack=_t(alias_pack, torch.float32, device),
                  height=int(height), width=int(width),
                  intensity=float(np.asarray(intensity)),
                  enabled=bool(np.asarray(enabled)))


def lights_from_arrays(*, pack, cdf, total_power,
                       device="cpu") -> LightTable:
    return LightTable(pack=_t(pack, torch.float32, device),
                      cdf=_t(cdf, torch.float32, device),
                      total_power=float(np.asarray(total_power, np.float32)))


def assets_from_reference(scene, dense, env, lights,
                          device="cpu") -> RenderAssets:
    """RenderAssets from the reference's SceneArrays, DenseMT, EnvMap and
    LightTable objects (any objects with those fields)."""
    return RenderAssets(
        scene=scene_from_arrays(
            positions=scene.positions, indices=scene.indices,
            vert_pack=scene.vert_pack, tri_pack=scene.tri_pack,
            tri_geom_pack=scene.tri_geom_pack, mat_pack=scene.mat_pack,
            material_ior=scene.materials.ior,
            volume_absorption=scene.materials.volume_absorption,
            device=device),
        env=env_from_arrays(
            radiance_quad=env.radiance_quad, alias_pack=env.alias_pack,
            height=env.height, width=env.width, intensity=env.intensity,
            enabled=env.enabled, device=device),
        lights=None if lights is None else lights_from_arrays(
            pack=lights.pack, cdf=lights.cdf,
            total_power=lights.total_power, device=device),
        dense=dense_from_arrays(
            aabb=dense.aabb, tri9=dense.tri9, center=dense.center,
            num_clusters=dense.num_clusters, device=device))
