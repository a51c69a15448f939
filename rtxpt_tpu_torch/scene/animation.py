"""Animation: glTF keyframe channels, skinning and the per-frame geometry
refresh (counterpart of rtxpt_tpu/scene/animation.py).

  * donut SceneGraph keyframe animations (per-frame transform refresh
    driven from Scene::Refresh, Sample.cpp:1980): `parse_animations`,
    `sample_channel` (clamped; LINEAR with quaternion slerp, or STEP),
    `apply_animation`, host numpy;
  * compute-shader skinning (donut Scene.cpp:745-800 skinning_cs):
    `joint_matrices` on the host, `skin_vertices` on the device;
  * the per-frame BLAS update (Sample.cpp:1353-1380): `refit_bvh8`
    rebuilds the leaf rows and refits the node bounds of a BVH8 on the
    device; `refresh_skinned` poses the scene and updates whichever trace
    structure it has (BVH8 refit, dense planes re-read, instance rows of
    the instanced TLAS).

A CUBICSPLINE sampler raises ValueError naming its channel: the reference
samples its packed (in-tangent, value, out-tangent) triplets as LINEAR
keys, which gives wrong poses. Morph-target `weights` channels are
skipped, as in the reference.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List

import numpy as np
import torch

from ..ops import bvh as bvh_mod
from ..ops import instanced, mt_dense
from .gltf import compute_world_transforms
from .types import tri_geom_pack_device

TRS = ("translation", "rotation", "scale")


@dataclasses.dataclass
class Channel:
    """One animation channel: node target + keyframe sampler."""
    node: int
    path: str                 # "translation" | "rotation" | "scale"
    times: np.ndarray         # (K,)
    values: np.ndarray        # (K, 3|4)
    interpolation: str = "LINEAR"


def parse_animations(gf) -> List[List[Channel]]:
    """The TRS channels of every animation of a gltf.GltfFile (anything
    with `.json` and `.accessor(i)`), one list per animation."""
    out = []
    for a, anim in enumerate(gf.json.get("animations", [])):
        channels = []
        for c, ch in enumerate(anim.get("channels", [])):
            tgt = ch.get("target", {})
            if tgt.get("path") not in TRS:
                continue
            smp = anim["samplers"][ch["sampler"]]
            interp = smp.get("interpolation", "LINEAR")
            if interp not in ("LINEAR", "STEP"):
                raise ValueError(
                    f"animation {a} channel {c} (node {tgt.get('node')} "
                    f"{tgt['path']}): {interp} interpolation is not "
                    "supported (LINEAR and STEP are)")
            channels.append(Channel(
                node=tgt["node"], path=tgt["path"],
                times=gf.accessor(smp["input"]).astype(np.float32),
                values=gf.accessor(smp["output"]).astype(np.float32),
                interpolation=interp))
        out.append(channels)
    return out


def _slerp(q0, q1, t):
    d = np.dot(q0, q1)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def sample_channel(ch: Channel, t: float) -> np.ndarray:
    """A channel's value at time t (clamped to its keys; LINEAR, slerp for
    rotations, or STEP)."""
    times = ch.times
    if t <= times[0]:
        return ch.values[0]
    if t >= times[-1]:
        return ch.values[-1]
    i = int(np.searchsorted(times, t) - 1)
    if ch.interpolation == "STEP":
        return ch.values[i]
    f = (t - times[i]) / max(times[i + 1] - times[i], 1e-9)
    if ch.path == "rotation":
        return _slerp(ch.values[i], ch.values[i + 1], float(f))
    return ch.values[i] * (1 - f) + ch.values[i + 1] * f


def apply_animation(nodes: list, channels: List[Channel], t: float):
    """Write the sampled TRS values into glTF node dicts (host); a value
    is replaced, never mutated, so shallow copies of the nodes suffice."""
    for ch in channels:
        nodes[ch.node][ch.path] = [float(v) for v in sample_channel(ch, t)]


def skin_vertices(rest_positions, rest_normals, joints, weights,
                  joint_mats):
    """Linear-blend skinning (skinning_cs, Scene.cpp:745-800) on the
    device: rest positions and normals (V,3) f32, joints (V,4) int,
    weights (V,4) f32, joint matrices (J,3,4) world * inverse bind ->
    (positions, unit normals) (V,3). The four weighted matrices are
    summed in joint order, so the card and the CPU round alike."""
    m = joint_mats[joints.long()]                        # (V,4,3,4)
    w = weights[:, :, None, None]
    blended = m[:, 0] * w[:, 0]                          # (V,3,4)
    for k in range(1, 4):
        blended = blended + m[:, k] * w[:, k]

    def apply(v):
        return (blended[:, :, 0] * v[:, 0:1] + blended[:, :, 1] * v[:, 1:2]
                + blended[:, :, 2] * v[:, 2:3])
    p = apply(rest_positions) + blended[:, :, 3]
    nrm = apply(rest_normals)
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-20)
    return p, nrm


def joint_matrices(world, skin: dict) -> np.ndarray:
    """(J,3,4) world * inverse bind per joint (skinning_cs constants)."""
    out = np.zeros((len(skin["joints"]), 3, 4), np.float32)
    for k, node_id in enumerate(skin["joints"]):
        w = world[node_id]
        ib = skin["inverse_bind"][k]
        out[k, :, :3] = w[:, :3] @ ib[:, :3]
        out[k, :, 3] = w[:, :3] @ ib[:, 3] + w[:, 3]
    return out


def refit_bvh8(bvh8: bvh_mod.BVH8, positions, indices) -> bvh_mod.BVH8:
    """The BVH8 with its leaf rows rebuilt from (posed) device positions
    and its node bounds refitted bottom-up, topology unchanged
    (rtxpt_tpu/scene/animation.py:111-182): a leaf row's triangles as
    (p0, e1, e2), a leaf slot's box over its triangles' vertices, a node
    slot's over its child row's slots, deepest level first. Node bounds
    are mins and maxes, so the refit is exact."""
    table = bvh8.table
    rows, width, leaf = table.shape[0], table.shape[1], bvh8.leaf_size
    tri_ids = bvh8.leaf_tris.reshape(rows, leaf)
    valid = tri_ids >= 0
    tri = indices[tri_ids.clamp(min=0).long()].long()       # (R,leaf,3)
    pts = positions[tri]                                     # (R,leaf,3,3)
    p0 = pts[:, :, 0]
    rows9 = torch.cat([p0, pts[:, :, 1] - p0, pts[:, :, 2] - p0], -1)
    leaf_data = torch.where(valid[..., None], rows9, 0.0).reshape(rows, -1)
    if leaf * 9 < width:
        leaf_data = torch.nn.functional.pad(leaf_data,
                                            (0, width - leaf * 9))
    is_leaf_row = valid.any(-1) & (torch.arange(rows, device=table.device)
                                   >= bvh8.num_nodes)
    table = torch.where(is_leaf_row[:, None], leaf_data, table)

    big = 1e30
    vmask = valid[..., None, None]
    row_lo = torch.where(vmask, pts, big).amin((1, 2))       # (R,3)
    row_hi = torch.where(vmask, pts, -big).amax((1, 2))
    codes, levels = bvh_mod.refit_topology(bvh8)
    for ids in levels[::-1]:
        c = codes[ids]                                       # (L,8)
        empty = (c == -1)[..., None]
        is_lf = c < -1
        src = torch.where(is_lf, (-c - 1) >> 5, c.clamp(min=0))
        s_lo = torch.where(empty, big, row_lo[src])          # (L,8,3)
        s_hi = torch.where(empty, -big, row_hi[src])
        table[ids, :48] = torch.cat([s_lo, s_hi], -1).reshape(-1, 48)
        row_lo[ids] = s_lo.amin(1)
        row_hi[ids] = s_hi.amax(1)
    return dataclasses.replace(bvh8, table=table)


def _animations(info: dict):
    """The file's parsed channels, parsed once per info dict: the poses do
    not depend on when they were parsed."""
    if "parsed_animations" not in info:
        info["parsed_animations"] = parse_animations(info["gltf"])
    return info["parsed_animations"]


def _moved_rigid(host: dict, world) -> list:
    """The rigid bindings whose node's world transform is not the baked
    one (np.allclose(.., atol=1e-7) per binding in the reference, one
    vectorized test here) with that transform: [(binding, (3,4))]."""
    bindings = host.get("rigid_bindings", [])
    if not bindings:
        return []
    baked = np.stack([b["baked_transform"] for b in bindings])
    xf = np.stack([np.asarray(world[b["node"]], np.float32)
                   for b in bindings])
    close = (np.abs(xf - baked) <= 1e-7 + 1e-5 * np.abs(baked)).all((1, 2))
    return [(bindings[i], xf[i]) for i in np.nonzero(~close)[0]]


def _rigid_pose(b: dict, xf: np.ndarray):
    """(positions, normals, tangents) of a rigid binding under transform
    xf, host numpy as the reference computes them."""
    lin = xf[:, :3]
    p = b["rest_positions"] @ lin.T + xf[:, 3]
    nrm_m = np.linalg.inv(lin).T
    n = b["rest_normals"] @ nrm_m.T
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    t = b["rest_tangents"].copy()
    t[:, :3] = t[:, :3] @ lin.T
    t[:, :3] /= np.maximum(np.linalg.norm(t[:, :3], axis=-1, keepdims=True),
                           1e-20)
    return p.astype(np.float32), n.astype(np.float32), t


def refresh_skinned(host: dict, info: dict, scene, accel, time: float,
                    animation_index: int = 0):
    """Pose the scene at `time` (rtxpt_tpu/scene/animation.py:194-293):
    animate the node TRS, skin each skin binding's vertex range on the
    device, re-flatten each rigid binding whose node moved (positions,
    normals and tangents), rebuild `vert_pack` and `tri_geom_pack`, then
    update the trace structure: a BVH8 is refitted, a DenseMT re-read
    (mt_dense.refresh_dense), an InstancedTL gets the moved instances'
    rows; the two-level BVH8 has no refit path and stays stale, with a
    warning, as in the reference. Returns (scene, accel).
    `host["instancing"]["transforms"]` follows the moved instances."""
    gf = info["gltf"]
    nodes = [dict(n) for n in gf.json.get("nodes", [])]
    anims = _animations(info)
    if anims and animation_index < len(anims):
        apply_animation(nodes, anims[animation_index], time)
    world = compute_world_transforms(gf.json, nodes)

    dev = scene.positions.device
    positions = scene.positions.clone()
    vert_pack = scene.vert_pack.clone()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    for b in host.get("skin_bindings", []):
        jm = t(joint_matrices(world, info["skins"][b["skin"]]))
        p, n = skin_vertices(t(b["rest_positions"]), t(b["rest_normals"]),
                             t(b["joints"]), t(b["weights"]), jm)
        s, c = b["vertex_start"], b["vertex_count"]
        positions[s:s + c] = p
        vert_pack[s:s + c, 0:3] = p
        vert_pack[s:s + c, 3:6] = n

    moved = _moved_rigid(host, world)
    if moved:
        # every moved range in one upload
        poses = [_rigid_pose(b, xf) for b, xf in moved]
        rows = t(np.concatenate([np.arange(b["vertex_start"],
                                           b["vertex_start"]
                                           + b["vertex_count"])
                                 for b, _ in moved])).long()
        p, n, tg = (t(np.concatenate([q[k] for q in poses]))
                    for k in range(3))
        positions[rows] = p
        vert_pack[rows, 0:3] = p
        vert_pack[rows, 3:6] = n
        vert_pack[rows, 6:10] = tg
        inst = host.get("instancing")
        if inst is not None:
            # the retained instance table follows, for the instanced TLAS
            # (set_instance_transform) and later rebuilds
            for b, xf in moved:
                inst["transforms"][b["instance"]] = xf
    scene = dataclasses.replace(
        scene, positions=positions, vert_pack=vert_pack,
        tri_geom_pack=tri_geom_pack_device(positions, vert_pack[:, 10:12],
                                           scene.indices))
    if isinstance(accel, bvh_mod.BVH8):
        accel = refit_bvh8(accel, positions, scene.indices)
    elif isinstance(accel, mt_dense.DenseMT):
        accel = mt_dense.refresh_dense(accel, positions, scene.indices)
    elif isinstance(accel, instanced.InstancedTL):
        # rigid motion is a row update, no BLAS touch (the reference's
        # per-frame TLAS build over static BLASes)
        for b, xf in moved:
            accel = instanced.set_instance_transform(
                accel, host["instancing"], b["instance"], xf)
    elif moved or host.get("skin_bindings"):
        warnings.warn("animated geometry over a BVH type without a refit "
                      "path (two-level soup): acceleration structure is "
                      "stale this frame")
    return scene, accel
