"""glTF 2.0 importer -> SceneBuilder (counterpart of
rtxpt_tpu/scene/gltf.py; donut GltfImporter, donut/src/engine/
GltfImporter.cpp): .gltf (JSON + .bin or data URIs) and .glb containers,
meshes (POSITION / NORMAL / TANGENT / TEXCOORD_0 / indices), the node
hierarchy with TRS or matrix transforms, pbrMetallicRoughness materials
with the extensions RTXPT reads (KHR_materials_transmission, _ior,
_emissive_strength, _volume, _specular, _pbrSpecularGlossiness,
KHR_texture_transform, KHR_lights_punctual), cameras, and textures.

Images decode with the port's readers: DDS (scene/dds.py) and PNG
(utils/image.py `decode_png_rgba`), to (H, W, 4) uint8 RGBA. An image in
any other format, or one that cannot be decoded, raises ValueError naming
the image and its format (the reference falls back to a white 4x4
texture). Skins: JOINTS_0 / WEIGHTS_0 (weights normalised to sum 1), each
skin's joints and inverse binds; a skinned node's meshes are placed at
their bind pose with `skin=` (scene/animation.py poses them), every other
mesh node's with `node=` (a rigid binding a node animation retargets).
`info` carries the parsed file (`gltf`) and the skins; `host["animations"]`
lists the nodes the file's animation channels target, which the
renderer's instanced gate reads (models/renderer.py).
"""
from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from .build import Mesh, SceneBuilder

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GltfFile:
    def __init__(self, path: str):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        if path.endswith(".glb"):
            with open(path, "rb") as f:
                data = f.read()
            magic, version, length = struct.unpack_from("<III", data, 0)
            if magic != 0x46546C67:
                raise ValueError(f"{path}: not a glb file")
            off = 12
            self.json = None
            self.bin = None
            while off < length:
                clen, ctype = struct.unpack_from("<II", data, off)
                chunk = data[off + 8:off + 8 + clen]
                if ctype == 0x4E4F534A:
                    self.json = json.loads(chunk.decode("utf-8"))
                elif ctype == 0x004E4942:
                    self.bin = chunk
                off += 8 + clen
        else:
            with open(path) as f:
                self.json = json.load(f)
            self.bin = None
        self._buffers: Dict[int, bytes] = {}

    def buffer(self, i: int) -> bytes:
        if i in self._buffers:
            return self._buffers[i]
        b = self.json["buffers"][i]
        uri = b.get("uri")
        if uri is None:
            data = self.bin
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote
            with open(os.path.join(self.dir, unquote(uri)), "rb") as f:
                data = f.read()
        self._buffers[i] = data
        return data

    def accessor(self, i: int) -> np.ndarray:
        a = self.json["accessors"][i]
        n_comp = _TYPE_COUNTS[a["type"]]
        dtype = _COMPONENT_DTYPES[a["componentType"]]
        count = a["count"]
        if "bufferView" not in a:
            out = np.zeros((count, n_comp), dtype)
        else:
            bv = self.json["bufferViews"][a["bufferView"]]
            data = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
            stride = bv.get("byteStride", 0)
            itemsize = np.dtype(dtype).itemsize * n_comp
            if stride and stride != itemsize:
                rows = []
                for k in range(count):
                    o = start + k * stride
                    rows.append(np.frombuffer(data, dtype, n_comp, o))
                out = np.stack(rows)
            else:
                out = np.frombuffer(data, dtype, count * n_comp,
                                    start).reshape(count, n_comp)
        # sparse accessors
        sp = a.get("sparse")
        if sp:
            out = out.copy()
            idx_acc = sp["indices"]
            bv = self.json["bufferViews"][idx_acc["bufferView"]]
            data = self.buffer(bv["buffer"])
            idt = _COMPONENT_DTYPES[idx_acc["componentType"]]
            start = bv.get("byteOffset", 0) + idx_acc.get("byteOffset", 0)
            ids = np.frombuffer(data, idt, sp["count"], start)
            val_acc = sp["values"]
            bv = self.json["bufferViews"][val_acc["bufferView"]]
            data = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + val_acc.get("byteOffset", 0)
            vals = np.frombuffer(data, dtype, sp["count"] * n_comp,
                                 start).reshape(sp["count"], n_comp)
            out[ids] = vals
        if a["type"] == "SCALAR":
            out = out[:, 0]
        # normalized integer attributes -> float
        if a.get("normalized"):
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / info.max
        return out


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        m = np.asarray(node["matrix"], np.float32).reshape(4, 4).T
        return m[:3, :4]
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    q = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = q
    rot = np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = rot * s[None, :]
    m[:, 3] = t
    return m


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a o b for (3,4) affines."""
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = a[:, :3] @ b[:, :3]
    m[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return m


def load_gltf(path: str, scene_builder: Optional[SceneBuilder] = None,
              texture_cache=None):
    """Parse a glTF file into a SceneBuilder; returns (host_scene_dict,
    info) where info carries the cameras, lights, textures and their
    colorspaces. texture_cache (scene/texcache.TextureCache): texture
    decode starts here on its pool and overlaps the geometry parse and
    the later builds; info['textures'] then holds futures."""
    gf = GltfFile(path)
    g = gf.json
    sb = scene_builder or SceneBuilder()
    early_textures = (decode_textures(gf, cache=texture_cache)
                      if texture_cache is not None else None)

    # ---- materials (donut GltfImporter material conversion)
    mat_ids: List[int] = []
    tex_sources: List[Optional[str]] = []
    for m in g.get("materials", [{}] if not g.get("materials") else []):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        exts = m.get("extensions", {})
        # legacy spec-gloss workflow -> metal-rough conversion (the
        # Khronos reference mapping, donut GltfImporter equivalent)
        sg = exts.get("KHR_materials_pbrSpecularGlossiness")
        if sg is not None:
            diff = np.asarray(sg.get("diffuseFactor", [1, 1, 1, 1]),
                              np.float32)
            specf = np.asarray(sg.get("specularFactor", [1, 1, 1]),
                               np.float32)
            gloss = float(sg.get("glossinessFactor", 1.0))
            spec_max = float(specf.max())
            metal = float(np.clip((spec_max - 0.04) / 0.96, 0.0, 1.0))
            base_rgb = diff[:3] * (1.0 - metal) + specf * metal
            base = [float(base_rgb[0]), float(base_rgb[1]),
                    float(base_rgb[2]),
                    float(diff[3]) if len(diff) > 3 else 1.0]
            pbr = dict(pbr)
            pbr["metallicFactor"] = metal
            pbr["roughnessFactor"] = 1.0 - gloss
            if "diffuseTexture" in sg and "baseColorTexture" not in pbr:
                pbr["baseColorTexture"] = sg["diffuseTexture"]
        trans = exts.get("KHR_materials_transmission", {}).get(
            "transmissionFactor", 0.0)
        ior = exts.get("KHR_materials_ior", {}).get("ior", 1.5)
        em_strength = exts.get("KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0)
        vol = exts.get("KHR_materials_volume", {})
        att_color = np.asarray(vol.get("attenuationColor", [1, 1, 1]),
                               np.float32)
        att_dist = vol.get("attenuationDistance", 0.0)
        absorption = (-np.log(np.maximum(att_color, 1e-4)) / att_dist
                      if att_dist > 0 else np.zeros(3, np.float32))
        alpha_mode = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}.get(
            m.get("alphaMode", "OPAQUE"), 0)
        emissive = np.asarray(m.get("emissiveFactor", [0, 0, 0]),
                              np.float32) * em_strength

        def tex_index(texinfo):
            return texinfo.get("index", -1) if texinfo else -1

        # KHR_texture_transform: full offset + ROTATION + scale, read
        # PER SLOT (base/normal/mr/emissive), composed per the KHR spec
        # (T = Translation * Rotation * Scale; uv' = T [u v 1]^T)
        def slot_affine(texinfo):
            tt = (texinfo or {}).get("extensions", {}).get(
                "KHR_texture_transform", {})
            ox, oy = tt.get("offset", [0.0, 0.0])
            sx, sy = tt.get("scale", [1.0, 1.0])
            r = float(tt.get("rotation", 0.0))
            c, s = np.cos(r), np.sin(r)
            # A = R @ S; t = offset
            return np.asarray([c * sx, s * sy, -s * sx, c * sy, ox, oy],
                              np.float32)

        uv_affine = np.concatenate([
            slot_affine(pbr.get("baseColorTexture")),
            slot_affine(m.get("normalTexture")),
            slot_affine(pbr.get("metallicRoughnessTexture")),
            slot_affine(m.get("emissiveTexture")),
        ])
        spec_ext = exts.get("KHR_materials_specular", {})
        specular_factor = float(spec_ext.get("specularFactor", 1.0))

        mat_ids.append(sb.add_material(
            base_color=np.asarray(base[:3], np.float32),
            metalness=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            ior=ior,
            transmission=trans,
            emissive=emissive,
            volume_absorption=absorption.astype(np.float32),
            thin_surface=not vol,  # volume ext marks thick-walled glass
            alpha_mode=alpha_mode,
            alpha_cutoff=m.get("alphaCutoff", 0.5),
            base_tex=tex_index(pbr.get("baseColorTexture")),
            metal_rough_tex=tex_index(pbr.get("metallicRoughnessTexture")),
            emissive_tex=tex_index(m.get("emissiveTexture")),
            normal_tex=tex_index(m.get("normalTexture")),
            transmission_tex=tex_index(
                exts.get("KHR_materials_transmission", {}).get(
                    "transmissionTexture")),
            double_sided=bool(m.get("doubleSided", False)),
            uv_affine=uv_affine,
            specular_factor=specular_factor,
        ))
    if not mat_ids:
        mat_ids = [sb.add_material()]

    # ---- meshes
    mesh_prims: List[List[int]] = []
    for mesh in g.get("meshes", []):
        prims = []
        for p in mesh.get("primitives", []):
            if p.get("mode", 4) != 4:
                continue  # triangles only
            attrs = p["attributes"]
            pos = gf.accessor(attrs["POSITION"]).astype(np.float32)
            nrm = (gf.accessor(attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else None)
            tan = (gf.accessor(attrs["TANGENT"]).astype(np.float32)
                   if "TANGENT" in attrs else None)
            uv = (gf.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else None)
            joints = (gf.accessor(attrs["JOINTS_0"]).astype(np.int32)
                      if "JOINTS_0" in attrs else None)
            weights = None
            if "WEIGHTS_0" in attrs:
                weights = gf.accessor(attrs["WEIGHTS_0"]).astype(np.float32)
                weights = weights / np.maximum(
                    weights.sum(-1, keepdims=True), 1e-6)
            if "indices" in p:
                idx = gf.accessor(p["indices"]).astype(np.int32)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int32)
            idx = idx.reshape(-1, 3)
            mid = mat_ids[p["material"]] if "material" in p else mat_ids[0]
            prims.append(sb.add_mesh(Mesh(pos, idx, nrm, tan, uv, mid,
                                          joints=joints, weights=weights)))
        mesh_prims.append(prims)

    # ---- node hierarchy -> world transforms + instances
    nodes = g.get("nodes", [])
    world: List[Optional[np.ndarray]] = [None] * len(nodes)
    cameras = []
    punctual_lights = []

    def visit(ni: int, parent: np.ndarray):
        node = nodes[ni]
        xf = _compose(parent, _node_transform(node))
        world[ni] = xf
        if "mesh" in node:
            skin = node.get("skin", -1)
            for mesh_id in mesh_prims[node["mesh"]]:
                if skin >= 0:
                    # skinned: the joint matrices place the geometry in
                    # world space; the instance transform stays identity
                    # (donut SkinnedMeshInstance semantics)
                    sb.add_instance(mesh_id, None, skin=skin)
                else:
                    sb.add_instance(mesh_id, xf, node=ni)
        if "camera" in node:
            cameras.append((g["cameras"][node["camera"]], xf))
        ext = node.get("extensions", {}).get("KHR_lights_punctual")
        if ext is not None:
            light = g.get("extensions", {}).get(
                "KHR_lights_punctual", {}).get("lights", [])[ext["light"]]
            punctual_lights.append((light, xf))
        for c in node.get("children", []):
            visit(c, xf)

    scene = g.get("scenes", [{}])[g.get("scene", 0)]
    ident = np.eye(3, 4, dtype=np.float32)
    for root in scene.get("nodes", range(len(nodes))):
        visit(root, ident)

    host = sb.finish()
    # per-texture colorspace: only baseColor/emissive sources are sRGB;
    # normal/metal-rough/transmission are linear DATA maps (donut
    # GltfImporter texture usage flags)
    n_tex = len(g.get("textures", []))
    srgb = [False] * n_tex
    for m in g.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        for ti in (pbr.get("baseColorTexture", {}).get("index", -1),
                   m.get("emissiveTexture", {}).get("index", -1)):
            if 0 <= ti < n_tex:
                srgb[ti] = True
    skins = []
    for sk in g.get("skins", []):
        joints = sk.get("joints", [])
        if "inverseBindMatrices" in sk:
            # glTF column-major 4x4 -> (3,4) affine rows
            m44 = gf.accessor(sk["inverseBindMatrices"]).astype(
                np.float32).reshape(-1, 4, 4)
            inv = np.ascontiguousarray(np.transpose(m44, (0, 2, 1))[:, :3])
        else:
            inv = np.tile(np.eye(3, 4, dtype=np.float32),
                          (len(joints), 1, 1))
        skins.append(dict(joints=list(joints), inverse_bind=inv))
    host["animations"] = sorted({
        ch["target"]["node"] for a in g.get("animations", [])
        for ch in a.get("channels", [])
        if ch.get("target", {}).get("path") in ("translation", "rotation",
                                                "scale")
        and "node" in ch["target"]})
    info = dict(cameras=cameras, lights=punctual_lights, gltf=gf,
                textures=(early_textures if early_textures is not None
                          else decode_textures(gf)),
                texture_srgb=srgb, skins=skins)
    return host, info


def compute_world_transforms(g: dict, nodes: list) -> list:
    """World (3,4) transform per node from (possibly animated) node dicts
    `nodes` over the scene of file json `g` (the per-frame SceneGraph::
    Refresh transform sweep); nodes outside the scene get identity."""
    world = [None] * len(nodes)
    ident = np.eye(3, 4, dtype=np.float32)

    def visit(ni, parent):
        xf = _compose(parent, _node_transform(nodes[ni]))
        world[ni] = xf
        for c in nodes[ni].get("children", []):
            visit(c, xf)

    scene = g.get("scenes", [{}])[g.get("scene", 0)]
    for root in scene.get("nodes", range(len(nodes))):
        visit(root, ident)
    return [ident if w is None else w for w in world]


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _decode_one_texture(gf: GltfFile, img: dict):
    """Decode one glTF image record (DDS or PNG) to (H, W, 4) uint8;
    anything else raises ValueError naming the image and its format."""
    from ..utils.image import decode_png_rgba
    from . import dds as DDS
    if "bufferView" in img:
        bv = gf.json["bufferViews"][img["bufferView"]]
        data = gf.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0)
        raw = data[start:start + bv["byteLength"]]
        name = f"{gf.path} image buffer view {img['bufferView']}"
    else:
        uri = img.get("uri", "")
        if uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
            name = f"{gf.path} image {uri[:uri.find(',')]}"
        else:
            from urllib.parse import unquote
            name = os.path.join(gf.dir, unquote(uri))
            with open(name, "rb") as f:
                raw = f.read()
    fmt = img.get("mimeType", "unknown format")
    if DDS.is_dds(raw):
        try:
            return DDS.decode_dds(raw)            # donut DDSFile path
        except ValueError as e:
            raise ValueError(f"{name}: DDS image: {e}") from e
    if raw[:8] == _PNG_SIG:
        return decode_png_rgba(raw, f"{name} (PNG)")
    raise ValueError(f"{name}: image format {fmt!r} ({raw[:4]!r}...) is "
                     "not read: the port decodes PNG and DDS images")


def decode_textures(gf: GltfFile, cache=None):
    """Decode glTF texture images (TextureCache equivalent); returns a
    list indexed by glTF texture index. With `cache`
    (scene/texcache.TextureCache) the list holds futures decoded on its
    pool, one per image source, which consumers resolve where they need
    the texels (texcache.resolve_image): decode overlaps the geometry
    parse and the trace-structure builds (donut TextureCache.cpp)."""
    out = []
    for tex in gf.json.get("textures", []):
        src = tex.get("source", -1)
        if src < 0:
            out.append(np.ones((4, 4, 4), np.float32))
            continue
        img = gf.json["images"][src]
        if cache is not None:
            out.append(cache.submit((id(gf), src),
                                    lambda im=img: _decode_one_texture(
                                        gf, im)))
        else:
            out.append(_decode_one_texture(gf, img))
    return out


def camera_from_info(info: dict, width: int, height: int):
    """First glTF camera, or a framing default."""
    import math
    from .camera import make_camera, look_at
    if info["cameras"]:
        cam, xf = info["cameras"][0]
        persp = cam.get("perspective", {})
        fov = persp.get("yfov", math.radians(60.0))
        pos = xf[:, 3]
        # glTF cameras look down -Z in node space
        direction = -xf[:, :3] @ np.asarray([0, 0, 1], np.float32)
        up = xf[:, :3] @ np.asarray([0, 1, 0], np.float32)
        return make_camera(width, height, pos, direction, up, fov_y=fov,
                           near_z=persp.get("znear", 0.001))
    return look_at(width, height, eye=(3, 3, 3), target=(0, 0.5, 0))


def analytic_lights_from_info(info: dict):
    """KHR_lights_punctual -> lights.py analytic list."""
    from . import lights as LI
    out = []
    for light, xf in info["lights"]:
        color = np.asarray(light.get("color", [1, 1, 1]), np.float32)
        inten = light.get("intensity", 1.0)
        t = light.get("type", "point")
        if t == "point":
            out.append(dict(kind=LI.LIGHT_POINT, position=xf[:, 3],
                            radiance=color * inten))
        elif t == "directional":
            d = xf[:, :3] @ np.asarray([0, 0, -1], np.float32)
            out.append(dict(kind=LI.LIGHT_DIRECTIONAL, direction=-d,
                            radiance=color * inten))
        elif t == "spot":
            # glTF spot points down the node's -Z
            # (donut/src/engine/GltfImporter.cpp:978-985)
            spot = light.get("spot", {})
            ax = xf[:, :3] @ np.asarray([0, 0, -1], np.float32)
            out.append(dict(
                kind=LI.LIGHT_SPOT, position=xf[:, 3],
                axis=ax, radiance=color * inten,
                inner_angle=float(spot.get("innerConeAngle", 0.0)),
                outer_angle=float(spot.get("outerConeAngle",
                                           np.pi / 4.0))))
    return out
