"""Build the port's render assets and realtime state from the reference
package's.

The parity tests run both packages on identical tables: the reference
builds its SceneArrays packs, DenseMT planes, BVH8, two-level BVH8 or
instanced TLAS tables, EnvMap and LightTable, and these functions turn
their fields (as numpy arrays) into the port's device tables. The
realtime converters do the same for the state one frame hands the next
(stable planes, the G-buffer, a PSR-lite frame's outputs, ReSTIR
reservoirs, ReLAX and ReBLUR histories, the TAA and TAAU histories);
the reference's uint32 branch ids and nested-dielectric stacks become the
port's int64. Of the BVHs only the f32 tables are carried; the
reference's bf16 planes serve its TPU kernel. The port's own host build
is checked against the same tables separately. Nothing here imports the
reference package: every input is read with ``numpy.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from .denoise.reblur import ReblurState
from .denoise.relax import DenoiserState
from .models.realtime import FrameOutputs
from .ops.bvh import BVH8
from .ops.bvh2l import BVH8TwoLevel
from .ops.instanced import InstancedTL
from .ops.mt_dense import DenseMT
from .post.taa import TAAState
from .post.taau import TAAUState
from .pt.gbuffer import GBuffer
from .pt.integrator import RenderAssets
from .pt.shading import BSDFData, ShadingData, SurfaceData
from .pt.stableplanes import StablePlanes
from .restir.gi import GIReservoir
from .restir.reservoir import Reservoir
from .scene.envmap import EnvMap
from .scene.lights import LightTable
from .scene.types import SceneArrays, TextureStack


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def textures_from_arrays(*, pool, mip_offset, mip_size, n_mips,
                         device="cuda") -> TextureStack:
    i32 = torch.int32
    return TextureStack(pool=_t(pool, torch.float32, device),
                        mip_offset=_t(mip_offset, i32, device),
                        mip_size=_t(mip_size, i32, device),
                        n_mips=_t(n_mips, i32, device))


def scene_from_arrays(*, positions, indices, vert_pack, tri_pack,
                      tri_geom_pack, mat_pack, material_ior,
                      volume_absorption, textures=None,
                      device="cuda") -> SceneArrays:
    """`textures`: the reference's TextureStack (any object with its
    fields) or None."""
    f32, i32 = torch.float32, torch.int32
    return SceneArrays(
        positions=_t(positions, f32, device), indices=_t(indices, i32, device),
        vert_pack=_t(vert_pack, f32, device),
        tri_pack=_t(tri_pack, i32, device),
        tri_geom_pack=_t(tri_geom_pack, f32, device),
        mat_pack=_t(mat_pack, f32, device),
        mat_ior=_t(material_ior, f32, device),
        volume_absorption=_t(volume_absorption, f32, device),
        textures=None if textures is None else textures_from_arrays(
            pool=textures.pool, mip_offset=textures.mip_offset,
            mip_size=textures.mip_size, n_mips=textures.n_mips,
            device=device))


def dense_from_arrays(*, aabb, tri9, center, num_clusters: int,
                      omm=None, device="cuda") -> DenseMT:
    """omm: the (NC*CLUSTER,) slot-order opacity masks, or None."""
    f32 = torch.float32
    return DenseMT(aabb=_t(aabb, f32, device), tri9=_t(tri9, f32, device),
                   center=_t(center, f32, device),
                   num_clusters=int(num_clusters),
                   omm=None if omm is None else _t(omm, torch.int32, device))


def bvh8_from_arrays(*, table, leaf_tris, leaf_omm, leaf_size: int,
                     num_nodes: int, device="cuda") -> BVH8:
    i32 = torch.int32
    return BVH8(table=_t(table, torch.float32, device),
                leaf_tris=_t(leaf_tris, i32, device),
                leaf_omm=_t(leaf_omm, i32, device),
                leaf_size=int(leaf_size), num_nodes=int(num_nodes))


def two_level_from_arrays(*, sub_tables, sub_leaf_tris, sub_leaf_omm,
                          sub_aabb, leaf_size: int, rows: int,
                          device="cuda") -> BVH8TwoLevel:
    f32, i32 = torch.float32, torch.int32
    return BVH8TwoLevel(sub_tables=_t(sub_tables, f32, device),
                        sub_leaf_tris=_t(sub_leaf_tris, i32, device),
                        sub_leaf_omm=_t(sub_leaf_omm, i32, device),
                        sub_aabb=_t(sub_aabb, f32, device),
                        leaf_size=int(leaf_size), rows=int(rows))


def instanced_from_arrays(*, mesh_tables, mesh_leaf_tris, inst_mesh,
                          inst_inv, inst_aabb, inst_tri_offset, inst_flip,
                          inst_by_mesh, leaf_size: int, rows: int,
                          device="cuda") -> InstancedTL:
    """The reference's leaves carry no opacity masks: every cell is set."""
    f32, i32 = torch.float32, torch.int32
    leaf_tris = _t(mesh_leaf_tris, i32, device)
    return InstancedTL(
        mesh_tables=_t(mesh_tables, f32, device), mesh_leaf_tris=leaf_tris,
        mesh_leaf_omm=torch.full_like(leaf_tris, 0xFFFF),
        inst_mesh=_t(inst_mesh, i32, device),
        inst_inv=_t(inst_inv, f32, device),
        inst_aabb=_t(inst_aabb, f32, device),
        inst_tri_offset=_t(inst_tri_offset, i32, device),
        inst_flip=_t(inst_flip, torch.bool, device),
        inst_by_mesh=_t(inst_by_mesh, i32, device),
        leaf_size=int(leaf_size), rows=int(rows))


def accel_from_reference(accel, device="cuda"):
    """The port's DenseMT, InstancedTL, BVH8 or BVH8TwoLevel from the
    reference's (any object with those fields). A BVH8 refits with the
    reference's topology: `bvh.refit_topology` reads it from the table's
    code columns."""
    if hasattr(accel, "tri9"):
        omm = None
        if getattr(accel, "has_omm", False):
            # the masks ride the fifth channel of the reference's weights:
            # row ci*5*CLUSTER + 4*CLUSTER + ki, column 15
            w = np.asarray(accel.weights)
            omm = w.reshape(accel.num_clusters, 5, -1, 16)[:, 4, :, 15] \
                .reshape(-1).astype(np.int32)
        return dense_from_arrays(aabb=accel.aabb, tri9=accel.tri9,
                                 center=accel.center,
                                 num_clusters=accel.num_clusters, omm=omm,
                                 device=device)
    if hasattr(accel, "inst_aabb"):
        return instanced_from_arrays(
            mesh_tables=accel.mesh_tables,
            mesh_leaf_tris=accel.mesh_leaf_tris, inst_mesh=accel.inst_mesh,
            inst_inv=accel.inst_inv, inst_aabb=accel.inst_aabb,
            inst_tri_offset=accel.inst_tri_offset,
            inst_flip=accel.inst_flip, inst_by_mesh=accel.inst_by_mesh,
            leaf_size=accel.leaf_size, rows=accel.rows, device=device)
    if hasattr(accel, "sub_aabb"):
        return two_level_from_arrays(
            sub_tables=accel.sub_tables, sub_leaf_tris=accel.sub_leaf_tris,
            sub_leaf_omm=accel.sub_leaf_omm, sub_aabb=accel.sub_aabb,
            leaf_size=accel.leaf_size, rows=accel.rows, device=device)
    return bvh8_from_arrays(table=accel.table, leaf_tris=accel.leaf_tris,
                            leaf_omm=accel.leaf_omm, leaf_size=accel.leaf_size,
                            num_nodes=accel.num_nodes, device=device)


def env_from_arrays(*, radiance_quad, alias_pack, height: int, width: int,
                    intensity=1.0, enabled=True, device="cuda") -> EnvMap:
    return EnvMap(radiance_quad=_t(radiance_quad, torch.float32, device),
                  alias_pack=_t(alias_pack, torch.float32, device),
                  height=int(height), width=int(width),
                  intensity=float(np.asarray(intensity)),
                  enabled=bool(np.asarray(enabled)))


def lights_from_arrays(*, pack, cdf, total_power, tri=None,
                       device="cuda") -> LightTable:
    """tri: the rows' triangle ids (-1 analytic), which refresh_pack reads,
    or None."""
    return LightTable(pack=_t(pack, torch.float32, device),
                      cdf=_t(cdf, torch.float32, device),
                      total_power=float(np.asarray(total_power, np.float32)),
                      tri=None if tri is None else _t(tri, torch.int32,
                                                      device))


def assets_from_reference(scene, accel, env, lights,
                          device="cuda") -> RenderAssets:
    """RenderAssets from the reference's SceneArrays, trace structure
    (DenseMT, BVH8 or BVH8TwoLevel), EnvMap and LightTable objects (any
    objects with those fields)."""
    return RenderAssets(
        scene=scene_from_arrays(
            positions=scene.positions, indices=scene.indices,
            vert_pack=scene.vert_pack, tri_pack=scene.tri_pack,
            tri_geom_pack=scene.tri_geom_pack, mat_pack=scene.mat_pack,
            material_ior=scene.materials.ior,
            volume_absorption=scene.materials.volume_absorption,
            textures=scene.textures, device=device),
        env=env_from_arrays(
            radiance_quad=env.radiance_quad, alias_pack=env.alias_pack,
            height=env.height, width=env.width, intensity=env.intensity,
            enabled=env.enabled, device=device),
        lights=None if lights is None else lights_from_arrays(
            pack=lights.pack, cdf=lights.cdf,
            total_power=lights.total_power,
            tri=getattr(lights, "tri", None), device=device),
        accel=accel_from_reference(accel, device))


def _fields(obj, cls, dtypes: dict, device, **given):
    """cls(**fields of obj), each as a tensor of dtypes.get(name, f32),
    except the fields `given`; uint32 fields widen to int64 on the host."""
    def conv(name):
        a = np.asarray(getattr(obj, name))
        dt = dtypes.get(name, torch.float32)
        return _t(a.astype(np.int64) if dt == torch.int64 else a, dt, device)
    return cls(**{f: given[f] if f in given else conv(f)
                  for f in cls._fields})


def reservoir_from_reference(r, device="cuda") -> Reservoir:
    return _fields(r, Reservoir, {"light": torch.int32}, device)


def gi_reservoir_from_reference(r, device="cuda") -> GIReservoir:
    return _fields(r, GIReservoir, {"valid": torch.bool}, device)


def denoiser_state_from_reference(s, device="cuda") -> DenoiserState:
    return _fields(s, DenoiserState, {}, device)


def taa_state_from_reference(s, device="cuda") -> TAAState:
    return TAAState(history=_t(np.asarray(s.history), torch.float32, device),
                    valid=bool(np.asarray(s.valid)))


def taau_state_from_reference(s, device="cuda") -> TAAUState:
    return TAAUState(history=_t(np.asarray(s.history), torch.float32,
                                device),
                     valid=bool(np.asarray(s.valid)))


def reblur_state_from_reference(s, device="cuda") -> ReblurState:
    return _fields(s, ReblurState, {}, device,
                   stab_valid=bool(np.asarray(s.stab_valid)))


def gbuffer_from_reference(gb, device="cuda") -> GBuffer:
    """The port's GBuffer, its SurfaceData included, from the reference's
    (trace_gbuffer's output)."""
    i32, b = torch.int32, torch.bool
    surf = gb.surface
    sd = _fields(surf.sd, ShadingData, dict(
        front_facing=b, material_id=i32, thin_surface=b,
        nested_priority=i32), device)
    surface = _fields(surf, SurfaceData, dict(alpha_mode=i32,
                                              double_sided=b), device,
                      sd=sd, bsdf_data=_fields(surf.bsdf_data, BSDFData, {},
                                               device))
    return _fields(gb, GBuffer, dict(valid=b, prim=i32, interior=torch.int64),
                   device, surface=surface)


def stable_planes_from_reference(sp, device="cuda") -> StablePlanes:
    i64 = torch.int64
    return _fields(sp, StablePlanes, dict(
        branch_id=i64, vertex_index=i64, prim=torch.int32, interior=i64,
        dominant=i64), device)


def frame_outputs_from_reference(fo, device="cuda"):
    """The port's FrameOutputs from the reference's (a PSR-lite frame's
    outputs); the reference's `color` field, always zeros there, has no
    counterpart."""
    return _fields(fo, FrameOutputs, {}, device,
                   reservoir=reservoir_from_reference(fo.reservoir, device),
                   gi_reservoir=gi_reservoir_from_reference(fo.gi_reservoir,
                                                            device))
