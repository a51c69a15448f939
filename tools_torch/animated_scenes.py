"""glTF writers of the animated scenes (no download: every file is made in
code from a seed), shared by chip_smoke.py and the tests:

  * `skinned_figure`: a tube of `rings` segments x `sides` over a chain of
    `joints` joints (rings / joints segments a joint, two non-zero
    weights a vertex, inverse binds), one animation of LINEAR rotation
    channels, one a joint, about seeded horizontal axes (0, +30, -30
    degrees at 0, 1 and 2 s); its last 8 segments are a second, emissive
    primitive of the same skin; a 2-triangle floor and a camera;
  * `rigid_city`: procedural.build_city() as a glTF: one mesh node per
    instance (a TRS node for the spheres, a matrix node for the rest),
    one glTF mesh per (mesh, material) pair that the city uses, all
    sharing the four meshes' accessors, the city's materials in the
    loader's terms, a camera, and one animation that moves `moving` of
    the sphere instances (LINEAR translation, up 1.5 at 1 s, back at 2 s);
    `animated=False` writes no animation;
  * `moving_quad`: a quad whose node translates +2 x over 1 s and a camera
    looking down -z from z = 4 (the reference's tests/test_cli_animate.py
    scene).

    python -m tools_torch.animated_scenes DIR    # writes all three
"""
from __future__ import annotations

import base64
import json
import os
import sys

import numpy as np


class _Blob:
    """Accessors, buffer views and one data-URI buffer."""

    def __init__(self):
        self.data, self.views, self.accessors = b"", [], []

    def add(self, a: np.ndarray, kind: str, component: int) -> int:
        a = np.ascontiguousarray(a)
        self.views.append({"buffer": 0, "byteOffset": len(self.data),
                           "byteLength": a.nbytes})
        count = a.shape[0] if a.ndim > 1 or kind == "SCALAR" else a.size
        acc = {"bufferView": len(self.views) - 1, "componentType": component,
               "count": int(count), "type": kind}
        if kind == "VEC3" and component == 5126:
            acc.update(min=a.min(0).tolist(), max=a.max(0).tolist())
        self.accessors.append(acc)
        self.data += a.tobytes()
        self.data += b"\0" * (-len(self.data) % 4)
        return len(self.accessors) - 1

    def doc(self, **fields) -> dict:
        return {"asset": {"version": "2.0"}, "scene": 0, **fields,
                "accessors": self.accessors, "bufferViews": self.views,
                "buffers": [{"byteLength": len(self.data),
                             "uri": "data:application/octet-stream;base64,"
                             + base64.b64encode(self.data).decode()}]}


def _column_major(xf: np.ndarray) -> list:
    m = np.eye(4, dtype=np.float64)
    m[:3, :4] = xf
    return [float(v) for v in m.T.reshape(-1)]


def _camera_node(eye, target, yfov: float) -> dict:
    """A camera node at `eye` looking at `target` (glTF cameras look down
    their -Z)."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    z = eye - target
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    xf = np.stack([x, np.cross(z, x), z, eye], 1)
    return {"camera": 0, "matrix": _column_major(xf)}


def _perspective(yfov: float) -> list:
    return [{"type": "perspective",
             "perspective": {"yfov": yfov, "znear": 0.01}}]


def _quat(axis, angle: float) -> list:
    s = np.sin(angle / 2.0)
    return [float(axis[0] * s), float(axis[1] * s), float(axis[2] * s),
            float(np.cos(angle / 2.0))]


def _write(path: str, doc: dict) -> str:
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def skinned_figure(path: str, rings: int = 512, sides: int = 24,
                   joints: int = 64, length: float = 4.0,
                   radius: float = 0.15, seed: int = 5) -> str:
    """Write the skinned figure to `path` (.gltf); returns `path`.
    Triangles: 2 * rings * sides + 2 (24,578 at the defaults)."""
    rng = np.random.default_rng(seed)
    blob = _Blob()
    q = rings // joints                   # segments a joint
    seg = length / joints
    theta = 2.0 * np.pi * np.arange(sides) / sides

    def tube(r0, r1):
        """Vertex rings r0..r1 and the segments between them."""
        i = np.arange(r0, r1 + 1)
        pos = np.stack([np.tile(radius * np.cos(theta), len(i)),
                        np.repeat(i * length / rings, sides),
                        np.tile(radius * np.sin(theta), len(i))], 1)
        nrm = np.stack([np.tile(np.cos(theta), len(i)),
                        np.zeros(len(i) * sides),
                        np.tile(np.sin(theta), len(i))], 1)
        j = np.minimum(i // q, joints - 1)
        f = ((i % q) + 0.5) / q
        jnt = np.zeros((len(i), 4), np.uint16)
        jnt[:, 0] = j
        jnt[:, 1] = np.minimum(j + 1, joints - 1)
        w = np.zeros((len(i), 4), np.float32)
        w[:, 0], w[:, 1] = 1.0 - f, f
        s = np.arange(sides)
        a = (np.arange(r1 - r0)[:, None] * sides + s[None]).reshape(-1)
        b = (np.arange(r1 - r0)[:, None] * sides
             + ((s + 1) % sides)[None]).reshape(-1)
        idx = np.stack([a, a + sides, b, b, a + sides, b + sides], 1)
        return {"POSITION": blob.add(pos.astype(np.float32), "VEC3", 5126),
                "NORMAL": blob.add(nrm.astype(np.float32), "VEC3", 5126),
                "JOINTS_0": blob.add(np.repeat(jnt, sides, 0), "VEC4", 5123),
                "WEIGHTS_0": blob.add(np.repeat(w, sides, 0), "VEC4", 5126),
                }, blob.add(idx.reshape(-1).astype(np.uint32), "SCALAR",
                            5125)

    body, body_idx = tube(0, rings - 8)
    tip, tip_idx = tube(rings - 8, rings)
    floor = np.asarray([[-6, -0.01, -6], [6, -0.01, -6], [6, -0.01, 6],
                        [-6, -0.01, 6]], np.float32)
    floor_acc = blob.add(floor, "VEC3", 5126)
    floor_idx = blob.add(np.asarray([0, 2, 1, 0, 3, 2], np.uint32), "SCALAR",
                         5125)
    inv_bind = np.stack([np.eye(4, dtype=np.float32)] * joints)
    inv_bind[:, 1, 3] = -seg * np.arange(joints)
    ib_acc = blob.add(np.transpose(inv_bind, (0, 2, 1)).reshape(joints, 16),
                      "MAT4", 5126)
    times = blob.add(np.asarray([0.0, 1.0, 2.0], np.float32), "SCALAR", 5126)
    first_joint = 3                       # nodes: figure, floor, camera
    nodes = [{"mesh": 0, "skin": 0}, {"mesh": 1},
             _camera_node((0.0, 2.2, 9.0), (0.0, 2.0, 0.0), 0.8)]
    channels, samplers = [], []
    for k in range(joints):
        nodes.append({"translation": [0.0, 0.0 if k == 0 else seg, 0.0]})
        if k + 1 < joints:
            nodes[-1]["children"] = [first_joint + k + 1]
        phi = rng.uniform(0.0, 2.0 * np.pi)
        axis = (np.cos(phi), 0.0, np.sin(phi))
        keys = np.asarray([_quat(axis, np.radians(a)) for a in (0, 30, -30)],
                          np.float32)
        samplers.append({"input": times, "output": blob.add(keys, "VEC4",
                                                            5126),
                         "interpolation": "LINEAR"})
        channels.append({"sampler": k, "target": {"node": first_joint + k,
                                                  "path": "rotation"}})
    doc = blob.doc(
        scenes=[{"nodes": [0, 1, 2, first_joint]}], nodes=nodes,
        cameras=_perspective(0.8),
        meshes=[{"primitives": [
            {"attributes": body, "indices": body_idx, "material": 0},
            {"attributes": tip, "indices": tip_idx, "material": 1}]},
            {"primitives": [{"attributes": {"POSITION": floor_acc},
                             "indices": floor_idx, "material": 2}]}],
        materials=[
            {"pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.5, 0.4, 1],
                                      "metallicFactor": 0.0,
                                      "roughnessFactor": 0.6},
             "doubleSided": True},
            {"pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1],
                                      "metallicFactor": 0.0},
             "emissiveFactor": [1.0, 0.8, 0.6], "doubleSided": True,
             "extensions": {"KHR_materials_emissive_strength": {
                 "emissiveStrength": 6.0}}},
            {"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.5, 0.5, 1],
                                      "metallicFactor": 0.0,
                                      "roughnessFactor": 0.9}}],
        skins=[{"joints": list(range(first_joint, first_joint + joints)),
                "inverseBindMatrices": ib_acc}],
        animations=[{"channels": channels, "samplers": samplers}])
    return _write(path, doc)


def _material(f: dict, m: int) -> dict:
    """Material m of SceneBuilder fields `f` in the terms the loader reads
    back (thick-walled, double-sided, emission as factor x strength)."""
    e = np.asarray(f["emissive"][m], np.float64)
    strength = float(e.max())
    out = {"pbrMetallicRoughness": {
        "baseColorFactor": [float(c) for c in f["base_color"][m]] + [1.0],
        "metallicFactor": float(f["metalness"][m]),
        "roughnessFactor": float(f["roughness"][m])},
        "doubleSided": True,
        "extensions": {"KHR_materials_volume": {"thicknessFactor": 1.0},
                       "KHR_materials_ior": {"ior": float(f["ior"][m])},
                       "KHR_materials_transmission": {
                           "transmissionFactor": float(
                               f["transmission"][m])}}}
    if strength > 0:
        out["emissiveFactor"] = [float(c) for c in e / strength]
        out["extensions"]["KHR_materials_emissive_strength"] = {
            "emissiveStrength": strength}
    return out


def rigid_city(path: str, moving: int = 64, animated: bool = True,
               blocks: int = 10) -> str:
    """Write build_city(blocks) as a glTF to `path`; returns `path`."""
    from rtxpt_tpu_torch.scene import procedural
    sb = procedural.build_city(blocks=blocks)
    blob = _Blob()
    mesh_acc = []
    for m in sb.meshes:
        a = {"POSITION": blob.add(m.positions.astype(np.float32), "VEC3",
                                  5126)}
        if m.normals is not None:
            a["NORMAL"] = blob.add(m.normals.astype(np.float32), "VEC3", 5126)
        if m.uvs is not None:
            a["TEXCOORD_0"] = blob.add(m.uvs.astype(np.float32), "VEC2", 5126)
        mesh_acc.append((a, blob.add(m.indices.reshape(-1).astype(np.uint32),
                                     "SCALAR", 5125)))
    spheres = {i for i, m in enumerate(sb.meshes)
               if m.indices.shape[0] >= 1280}
    pairs, meshes, nodes = {}, [], []
    channels, samplers = [], []
    times = blob.add(np.asarray([0.0, 1.0, 2.0], np.float32), "SCALAR", 5126)
    for inst in sb.instances:
        mat = inst.material_override if inst.material_override >= 0 \
            else sb.meshes[inst.mesh].material
        key = (inst.mesh, mat)
        if key not in pairs:
            pairs[key] = len(meshes)
            attrs, idx = mesh_acc[inst.mesh]
            meshes.append({"primitives": [{"attributes": attrs,
                                           "indices": idx,
                                           "material": mat}]})
        xf = inst.transform
        node = {"mesh": pairs[key]}
        if inst.mesh in spheres:
            # uniform scale, no rotation: a TRS node an animation can move
            node.update(translation=[float(v) for v in xf[:, 3]],
                        scale=[float(xf[0, 0])] * 3)
            if animated and len(channels) < moving:
                base = np.asarray(xf[:, 3], np.float32)
                keys = np.stack([base, base + [0.0, 1.5, 0.0], base])
                samplers.append({"input": times, "output": blob.add(
                    keys.astype(np.float32), "VEC3", 5126),
                    "interpolation": "LINEAR"})
                channels.append({"sampler": len(samplers) - 1, "target": {
                    "node": len(nodes), "path": "translation"}})
        else:
            node["matrix"] = _column_major(xf)
        nodes.append(node)
    half = blocks * 6.0
    nodes.append(_camera_node((half * 0.8, 14.0, half * 0.9), (0.0, 2.0, 0.0),
                              float(np.radians(60.0))))
    f = sb.material_fields
    doc = blob.doc(scenes=[{"nodes": list(range(len(nodes)))}], nodes=nodes,
                   cameras=_perspective(float(np.radians(60.0))),
                   meshes=meshes,
                   materials=[_material(f, m) for m in range(sb._nmat)])
    if channels:
        doc["animations"] = [{"channels": channels, "samplers": samplers}]
    return _write(path, doc)


def moving_quad(path: str) -> str:
    """Write the moving quad to `path`; returns `path`."""
    blob = _Blob()
    pos = blob.add(np.asarray([[-0.5, -0.5, 0], [0.5, -0.5, 0],
                               [-0.5, 0.5, 0], [0.5, 0.5, 0]], np.float32),
                   "VEC3", 5126)
    idx = blob.add(np.asarray([0, 1, 2, 2, 1, 3], np.uint16), "SCALAR", 5123)
    times = blob.add(np.asarray([0.0, 1.0], np.float32), "SCALAR", 5126)
    vals = blob.add(np.asarray([[0, 0, 0], [2, 0, 0]], np.float32), "VEC3",
                    5126)
    doc = blob.doc(
        scenes=[{"nodes": [0, 1]}],
        nodes=[{"mesh": 0}, {"camera": 0, "translation": [0, 0, 4]}],
        cameras=[{"type": "perspective",
                  "perspective": {"yfov": 0.9, "znear": 0.01}}],
        meshes=[{"primitives": [{"attributes": {"POSITION": pos},
                                 "indices": idx, "material": 0}]}],
        materials=[{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.2, 0.2, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.8}}],
        animations=[{"channels": [{"sampler": 0, "target": {
            "node": 0, "path": "translation"}}],
            "samplers": [{"input": times, "output": vals,
                          "interpolation": "LINEAR"}]}])
    return _write(path, doc)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "."
    os.makedirs(out, exist_ok=True)
    for name, fn in (("figure.gltf", skinned_figure),
                     ("city.gltf", rigid_city), ("quad.gltf", moving_quad)):
        print(fn(os.path.join(out, name)))
