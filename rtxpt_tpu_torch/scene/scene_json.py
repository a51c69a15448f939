"""Scene description files, .scene.json (counterpart of
rtxpt_tpu/scene/scene_json.py; the reference's scene-json extensions over
glTF, RTXPT/ExtendedScene.h: EnvironmentLight :20, PerspectiveCameraEx
:35, SampleSettings :83 consumed at Sample.cpp:629-649): a JSON wrapper
that references glTF assets and adds the environment, the camera, analytic
lights and per-scene renderer settings.

Schema:
{
  "models": ["relative/path.gltf", ...],         # merged into one scene
  "environment": {"type": "procedural-sky",      # or "constant"
                  "intensity": 1.0, "sun_dir": [x,y,z],
                  "sun_radiance": [r,g,b], "sky_scale": 1.0},
  "camera": {"position": [..], "target"|"direction": [..], "up": [..],
             "fov_y_degrees": 60, "aperture": 0.0,
             "focal_distance": 1.0},
  "lights": [{"type": "point"|"directional"|"sphere", ...}],
  "settings": {"max_bounces": 30, ...}           # PTConfig overrides
}
The models' textures are decoded on one texture cache
(scene/texcache.py) and set on the host dict as `texture_images` and
`texture_srgb`, each model's texture indices offset by the textures of
the models before it.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np


def load_scene_json(path: str, width: int, height: int):
    """Returns (host_scene, camera, extra) where extra carries
    env_radiance, env_intensity, analytic_lights and the settings."""
    from . import envmap as EM
    from . import gltf as G
    from .build import SceneBuilder
    from .camera import look_at, make_camera
    from .texcache import TextureCache

    with open(path) as f:
        doc = json.load(f)
    base = os.path.dirname(os.path.abspath(path))

    sb = SceneBuilder()
    cache = TextureCache()
    analytic, images, srgb = [], [], []
    for rel in doc.get("models", []):
        first_mat = len(sb.material_fields["base_tex"])
        _, info = G.load_gltf(os.path.join(base, rel), sb,
                              texture_cache=cache)
        analytic += G.analytic_lights_from_info(info)
        # this model's materials index its own textures
        for k in ("base_tex", "emissive_tex", "metal_rough_tex",
                  "normal_tex", "transmission_tex"):
            col = sb.material_fields[k]
            for m in range(first_mat, len(col)):
                if col[m] >= 0:
                    col[m] = col[m] + len(images)
        images += info["textures"]
        srgb += info["texture_srgb"]

    host = sb.finish()
    if images:
        host["texture_images"] = images
        host["texture_srgb"] = srgb

    env_cfg = doc.get("environment", {})
    kind = env_cfg.get("type", "procedural-sky")
    if kind == "constant":
        val = np.asarray(env_cfg.get("radiance", [1, 1, 1]), np.float32)
        env = np.tile(val, (64, 128, 1))
    else:
        kwargs = {}
        for k_json, k_py in [("sun_dir", "sun_dir"),
                             ("sun_radiance", "sun_radiance"),
                             ("sky_scale", "sky_scale")]:
            if k_json in env_cfg:
                kwargs[k_py] = env_cfg[k_json]
        env = EM.bake_procedural_sky(**kwargs)

    cam_cfg = doc.get("camera", {})
    pos = cam_cfg.get("position", [4, 3, 4])
    fov = math.radians(cam_cfg.get("fov_y_degrees", 60.0))
    common = dict(fov_y=fov,
                  aperture_radius=cam_cfg.get("aperture", 0.0),
                  focal_distance=cam_cfg.get("focal_distance", 1.0))
    if "direction" in cam_cfg:
        cam = make_camera(width, height, pos, cam_cfg["direction"],
                          cam_cfg.get("up", (0, 1, 0)), **common)
    else:
        cam = look_at(width, height, eye=pos,
                      target=cam_cfg.get("target", [0, 0, 0]),
                      up=tuple(cam_cfg.get("up", (0, 1, 0))), **common)

    from . import lights as LI
    kind_map = {"point": LI.LIGHT_POINT,
                "directional": LI.LIGHT_DIRECTIONAL,
                "sphere": LI.LIGHT_SPHERE}
    for l in doc.get("lights", []):
        analytic.append(dict(
            kind=kind_map.get(l.get("type", "point"), LI.LIGHT_POINT),
            position=l.get("position", l.get("direction", [0, 1, 0])),
            radiance=l.get("radiance", [1, 1, 1]),
            radius=l.get("radius", 0.0)))

    extra = dict(env_radiance=env,
                 env_intensity=env_cfg.get("intensity", 1.0),
                 analytic_lights=analytic,
                 settings=doc.get("settings", {}))
    return host, cam, extra
