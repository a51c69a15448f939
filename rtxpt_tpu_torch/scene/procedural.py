"""Procedural test scenes (counterpart of rtxpt_tpu/scene/procedural.py).

The "programmer-art" scene: a ground plane, boxes and spheres with
materials that exercise every BSDF lobe (diffuse, rough metal, mirror,
glass, rough glass, emissive panel). Host-side numpy, identical to the
reference's builder so both packages render the same tables. The
Bistro-class `build_city` comes with the large-scene trace paths.
"""
from __future__ import annotations

import numpy as np

from .build import Mesh, SceneBuilder


def make_box(extent=(1.0, 1.0, 1.0)) -> Mesh:
    ex, ey, ez = [e * 0.5 for e in extent]
    # 24 vertices (per-face normals/uvs)
    faces = [
        ((0, 0, 1), [(-ex, -ey, ez), (ex, -ey, ez), (ex, ey, ez),
                     (-ex, ey, ez)]),
        ((0, 0, -1), [(ex, -ey, -ez), (-ex, -ey, -ez), (-ex, ey, -ez),
                      (ex, ey, -ez)]),
        ((1, 0, 0), [(ex, -ey, ez), (ex, -ey, -ez), (ex, ey, -ez),
                     (ex, ey, ez)]),
        ((-1, 0, 0), [(-ex, -ey, -ez), (-ex, -ey, ez), (-ex, ey, ez),
                      (-ex, ey, -ez)]),
        ((0, 1, 0), [(-ex, ey, ez), (ex, ey, ez), (ex, ey, -ez),
                     (-ex, ey, -ez)]),
        ((0, -1, 0), [(-ex, -ey, -ez), (ex, -ey, -ez), (ex, -ey, ez),
                      (-ex, -ey, ez)]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for i, (n, quad) in enumerate(faces):
        base = len(pos)
        pos.extend(quad)
        nrm.extend([n] * 4)
        uv.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        idx.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
    return Mesh(np.asarray(pos, np.float32), np.asarray(idx, np.int32),
                np.asarray(nrm, np.float32), None,
                np.asarray(uv, np.float32))


def make_quad(size=(1.0, 1.0)) -> Mesh:
    """XZ plane facing +Y."""
    sx, sz = size[0] * 0.5, size[1] * 0.5
    pos = np.asarray([(-sx, 0, -sz), (sx, 0, -sz), (sx, 0, sz), (-sx, 0, sz)],
                     np.float32)
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    uv = np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    idx = np.asarray([(0, 2, 1), (0, 3, 2)], np.int32)
    return Mesh(pos, idx, nrm, None, uv)


def make_icosphere(radius=1.0, subdivisions=3) -> Mesh:
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.asarray([
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key in cache:
            return cache[key]
        m = np.asarray(verts[a]) + np.asarray(verts[b])
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdivisions):
        nf = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nf
    v = np.asarray(verts, np.float32)
    n = v.copy()
    # spherical uvs
    uv = np.stack([0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(v[:, 1], -1, 1)) / np.pi],
                  axis=-1).astype(np.float32)
    return Mesh(v * radius, np.asarray(faces, np.int32), n, None, uv)


def translate(x, y, z):
    m = np.eye(3, 4, dtype=np.float32)
    m[:, 3] = (x, y, z)
    return m


def trs(t=(0, 0, 0), s=1.0, ry=0.0):
    c, sn = np.cos(ry), np.sin(ry)
    rot = np.asarray([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = rot * s
    m[:, 3] = t
    return m


def build_programmer_art(diffuse_only: bool = False,
                         with_emissive: bool = True) -> SceneBuilder:
    """The standard test scene. With diffuse_only=True all materials are
    lambertian (BASELINE config 1); otherwise the full lobe zoo."""
    sb = SceneBuilder()
    white = sb.add_material(base_color=(0.73, 0.73, 0.73), roughness=1.0)
    red = sb.add_material(base_color=(0.63, 0.065, 0.05), roughness=1.0)
    green = sb.add_material(base_color=(0.14, 0.45, 0.091), roughness=1.0)
    blue = sb.add_material(base_color=(0.12, 0.22, 0.62), roughness=1.0)
    if diffuse_only:
        metal = sb.add_material(base_color=(0.8, 0.6, 0.2), roughness=1.0)
        mirror = sb.add_material(base_color=(0.9, 0.9, 0.9), roughness=1.0)
        glass = sb.add_material(base_color=(0.95, 0.95, 0.95), roughness=1.0)
        rough_glass = glass
    else:
        metal = sb.add_material(base_color=(0.944, 0.776, 0.373),
                                metalness=1.0, roughness=0.25)
        mirror = sb.add_material(base_color=(0.95, 0.95, 0.95),
                                 metalness=1.0, roughness=0.0)
        glass = sb.add_material(base_color=(0.99, 0.99, 0.99), roughness=0.0,
                                transmission=1.0, ior=1.5,
                                nested_priority=1,
                                volume_absorption=(0.03, 0.01, 0.005))
        rough_glass = sb.add_material(base_color=(0.9, 0.95, 1.0),
                                      roughness=0.2, transmission=1.0,
                                      ior=1.5, nested_priority=1)
    emissive = sb.add_material(base_color=(0.0, 0.0, 0.0),
                               emissive=(20.0, 18.0, 14.0),
                               excluded_from_nee=False)

    ground = sb.add_mesh(make_quad((20.0, 20.0)))
    box = sb.add_mesh(make_box((1.0, 1.0, 1.0)))
    tallbox = sb.add_mesh(make_box((1.0, 2.2, 1.0)))
    sphere = sb.add_mesh(make_icosphere(0.55, 3))
    panel = sb.add_mesh(make_quad((1.6, 1.2)))

    sb.add_instance(ground, translate(0, 0, 0), white)
    sb.add_instance(box, trs((-1.4, 0.5, 0.3), 1.0, 0.4), red)
    sb.add_instance(tallbox, trs((1.2, 1.1, -0.9), 1.0, -0.3), green)
    sb.add_instance(box, trs((0.1, 0.35, 1.5), 0.7, 0.9), blue)
    sb.add_instance(sphere, translate(-0.2, 0.55, 0.2), metal)
    sb.add_instance(sphere, translate(1.3, 0.55, 0.9), glass)
    sb.add_instance(sphere, translate(-1.6, 0.55, -1.4), mirror)
    sb.add_instance(sphere, translate(0.9, 0.55, 2.3), rough_glass)
    if with_emissive:
        # downward-facing emissive panel above the scene
        m = trs((0.0, 3.2, 0.0), 1.0, 0.0)
        m[1, 1] = -1.0  # flip to face down
        sb.add_instance(panel, m, emissive)
    return sb


def default_camera(width: int, height: int):
    from .camera import look_at
    import math
    return look_at(width, height, eye=(4.2, 2.6, 4.6),
                   target=(0.0, 0.7, 0.0), fov_y=math.radians(55.0))
