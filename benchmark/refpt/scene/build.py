"""Host-side scene assembly (counterpart of rtxpt_tpu/scene/build.py).

numpy mesh pool + instance flattening to world space, then `to_device`
uploads the packed tables to one torch device. `finish()` also keeps what
animation needs (scene/animation.py): the object-space rest pose, joints
and weights of each skinned instance (`skin_bindings`), the rest geometry
and baked transform of each instance rooted at a scene-graph node
(`rigid_bindings`), and the un-flattened instancing the instanced TLAS
builds from (`instancing`, ops/instanced.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .types import SceneArrays, default_material_table, pack_tables


@dataclasses.dataclass
class Mesh:
    """One geometry in object space."""
    positions: np.ndarray            # (V,3)
    indices: np.ndarray              # (T,3)
    normals: Optional[np.ndarray] = None
    tangents: Optional[np.ndarray] = None   # (V,4)
    uvs: Optional[np.ndarray] = None
    material: int = 0
    joints: Optional[np.ndarray] = None     # (V,4) i32 skin joints
    weights: Optional[np.ndarray] = None    # (V,4) f32 skin weights


@dataclasses.dataclass
class Instance:
    mesh: int
    transform: np.ndarray            # (3,4) affine, row-major
    material_override: int = -1
    skin: int = -1                   # skin id (scene/gltf.py skins list)
    node: int = -1                   # source scene-graph node (rigid
    #                                  animation retargets this instance)


def compute_vertex_normals(positions: np.ndarray,
                           indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    n = np.zeros_like(positions)
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    l = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(l, 1e-20)).astype(np.float32)


def compute_tangents(positions, normals, uvs, indices) -> np.ndarray:
    """MikkTSpace-style averaged tangents from UV derivatives; falls back
    to an arbitrary frame where UVs are degenerate."""
    v = positions.shape[0]
    tan = np.zeros((v, 3), np.float64)
    p = [positions[indices[:, k]] for k in range(3)]
    t = [uvs[indices[:, k]] for k in range(3)]
    e1, e2 = p[1] - p[0], p[2] - p[0]
    du1, dv1 = t[1][:, 0] - t[0][:, 0], t[1][:, 1] - t[0][:, 1]
    du2, dv2 = t[2][:, 0] - t[0][:, 0], t[2][:, 1] - t[0][:, 1]
    r = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(r) < 1e-12, 1.0, r)
    tdir = ((dv2[:, None] * e1 - dv1[:, None] * e2) / r[:, None])
    for k in range(3):
        np.add.at(tan, indices[:, k], tdir)
    # Gram-Schmidt against the normal
    tan -= normals * np.sum(tan * normals, axis=-1, keepdims=True)
    l = np.linalg.norm(tan, axis=-1, keepdims=True)
    bad = l[:, 0] < 1e-8
    alt = np.cross(normals, np.array([0.0, 1.0, 0.0]))
    alt2 = np.cross(normals, np.array([1.0, 0.0, 0.0]))
    alt = np.where(np.linalg.norm(alt, axis=-1, keepdims=True) < 1e-4,
                   alt2, alt)
    tan = np.where(bad[:, None], alt, tan / np.maximum(l, 1e-20))
    w = np.ones((v, 1), np.float32)
    return np.concatenate([tan.astype(np.float32), w], axis=-1)


class SceneBuilder:
    """Accumulates meshes/instances/materials; `finish()` flattens to
    world space and returns the host-side numpy scene dict."""

    def __init__(self):
        self.meshes: List[Mesh] = []
        self.instances: List[Instance] = []
        self.material_fields: dict = {k: [] for k in
                                      default_material_table(0)}
        self._nmat = 0

    def add_material(self, **kwargs) -> int:
        defaults = default_material_table(1)
        for k, arr in defaults.items():
            v = kwargs.pop(k, arr[0])
            self.material_fields[k].append(np.asarray(v, arr.dtype))
        if kwargs:
            raise ValueError(f"unknown material fields: {list(kwargs)}")
        self._nmat += 1
        return self._nmat - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def add_instance(self, mesh: int, transform: Optional[np.ndarray] = None,
                     material_override: int = -1, skin: int = -1,
                     node: int = -1) -> int:
        if transform is None:
            transform = np.eye(3, 4, dtype=np.float32)
        self.instances.append(Instance(mesh, np.asarray(transform,
                                                        np.float32),
                                       material_override, skin, node))
        return len(self.instances) - 1

    def finish(self) -> dict:
        if self._nmat == 0:
            self.add_material()
        pos_l, nrm_l, tan_l, uv_l, idx_l, mat_l, inst_l = \
            [], [], [], [], [], [], []
        skin_bindings, rigid_bindings = [], []
        voffset = 0
        for iid, inst in enumerate(self.instances):
            m = self.meshes[inst.mesh]
            xf = inst.transform
            p = m.positions @ xf[:, :3].T + xf[:, 3]
            # normal matrix = inverse-transpose of linear part
            lin = xf[:, :3]
            nrm_m = np.linalg.inv(lin).T
            n = m.normals if m.normals is not None else \
                compute_vertex_normals(m.positions, m.indices)
            n = n @ nrm_m.T
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            uv = m.uvs if m.uvs is not None else \
                np.zeros((p.shape[0], 2), np.float32)
            if m.tangents is not None:
                t4 = m.tangents.copy()
                t4[:, :3] = t4[:, :3] @ lin.T
                t4[:, :3] /= np.maximum(
                    np.linalg.norm(t4[:, :3], axis=-1, keepdims=True), 1e-20)
            else:
                t4 = compute_tangents(p, n, uv, m.indices)
            pos_l.append(p.astype(np.float32))
            nrm_l.append(n.astype(np.float32))
            tan_l.append(t4.astype(np.float32))
            uv_l.append(uv.astype(np.float32))
            inst_idx = m.indices.astype(np.int32)
            if np.linalg.det(lin) < 0.0:
                # mirroring transform: flip winding so face normals stay
                # consistent with the transformed shading normals
                inst_idx = inst_idx[:, ::-1]
            idx_l.append(inst_idx + voffset)
            mid = (inst.material_override if inst.material_override >= 0
                   else m.material)
            mat_l.append(np.full((m.indices.shape[0],), mid, np.int32))
            inst_l.append(np.full((m.indices.shape[0],), iid, np.int32))
            if inst.skin >= 0 and m.joints is not None:
                # skinned instance: the object-space rest pose, joints and
                # weights; skinning replaces this vertex range each frame
                # (donut Scene::Refresh skinning_cs path)
                skin_bindings.append(dict(
                    instance=iid, skin=inst.skin,
                    vertex_start=voffset, vertex_count=p.shape[0],
                    rest_positions=np.asarray(m.positions, np.float32),
                    rest_normals=np.asarray(
                        m.normals if m.normals is not None else
                        compute_vertex_normals(m.positions, m.indices),
                        np.float32),
                    joints=np.asarray(m.joints, np.int32),
                    weights=np.asarray(m.weights, np.float32)))
            elif inst.node >= 0:
                # rigid instance rooted at a scene-graph node: the rest
                # geometry and baked transform, so that a node animation
                # re-flattens just this vertex range (donut SceneGraph
                # transform refresh)
                rest_n = (m.normals if m.normals is not None else
                          compute_vertex_normals(m.positions, m.indices))
                if m.tangents is not None:
                    rest_t = np.asarray(m.tangents, np.float32)
                else:
                    rest_uv = (m.uvs if m.uvs is not None else
                               np.zeros((m.positions.shape[0], 2),
                                        np.float32))
                    rest_t = compute_tangents(
                        np.asarray(m.positions, np.float32),
                        np.asarray(rest_n, np.float32), rest_uv, m.indices)
                rigid_bindings.append(dict(
                    instance=iid, node=inst.node,
                    vertex_start=voffset, vertex_count=p.shape[0],
                    baked_transform=np.asarray(xf, np.float32).copy(),
                    rest_positions=np.asarray(m.positions, np.float32),
                    rest_normals=np.asarray(rest_n, np.float32),
                    rest_tangents=np.asarray(rest_t, np.float32)))
            voffset += p.shape[0]

        mats = {k: np.stack(v) if np.ndim(v[0]) else np.array(v)
                for k, v in self.material_fields.items()}
        if not idx_l:
            # degenerate never-hit triangle so gathers stay well-formed
            pos_l = [np.zeros((3, 3), np.float32)]
            nrm_l = [np.tile(np.asarray([[0, 1, 0]], np.float32), (3, 1))]
            tan_l = [np.tile(np.asarray([[1, 0, 0, 1]], np.float32),
                             (3, 1))]
            uv_l = [np.zeros((3, 2), np.float32)]
            idx_l = [np.asarray([[0, 1, 2]], np.int32)]
            mat_l = [np.zeros((1,), np.int32)]
            inst_l = [np.zeros((1,), np.int32)]
        # the un-flattened structure of the instanced TLAS (ops/
        # instanced.py): each instance's mesh, transform and first flat
        # triangle, and each mesh's object-space geometry
        # (RTXPT/Sample.cpp:1353-1421's TLAS-over-BLAS shape)
        tri_offsets = np.cumsum([0] + [self.meshes[i.mesh].indices.shape[0]
                                       for i in self.instances])[:-1]
        instancing = dict(
            mesh_of_instance=np.asarray([i.mesh for i in self.instances],
                                        np.int32),
            transforms=np.stack([i.transform for i in self.instances])
            .astype(np.float32),
            tri_offset=tri_offsets.astype(np.int32),
            meshes=[dict(positions=np.asarray(m.positions, np.float32),
                         indices=np.asarray(m.indices, np.int32))
                    for m in self.meshes],
        ) if self.instances else None
        return dict(
            instancing=instancing,
            positions=np.concatenate(pos_l),
            normals=np.concatenate(nrm_l),
            tangents=np.concatenate(tan_l),
            uvs=np.concatenate(uv_l),
            indices=np.concatenate(idx_l),
            tri_mat=np.concatenate(mat_l),
            tri_instance=np.concatenate(inst_l),
            materials=mats,
            skin_bindings=skin_bindings,
            rigid_bindings=rigid_bindings,
        )


def to_device(host: dict, device, textures=None) -> SceneArrays:
    """Pack the host dict of SceneBuilder.finish() and upload it, with the
    texture stack `textures` (scene/textures.py) where the scene has one."""
    vp, tp, tg, mp = pack_tables(
        np.asarray(host["positions"]), np.asarray(host["normals"]),
        np.asarray(host["tangents"]), np.asarray(host["uvs"]),
        np.asarray(host["indices"]), np.asarray(host["tri_mat"]),
        host["materials"])
    mats = host["materials"]
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=device)
    return SceneArrays(
        positions=t(host["positions"], torch.float32),
        indices=t(host["indices"], torch.int32),
        vert_pack=t(vp, torch.float32),
        tri_pack=t(tp, torch.int32),
        tri_geom_pack=t(tg, torch.float32),
        mat_pack=t(mp, torch.float32),
        mat_ior=t(mats["ior"], torch.float32),
        volume_absorption=t(mats["volume_absorption"], torch.float32),
        textures=textures)
