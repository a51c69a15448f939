"""Renderer: reference-mode frame orchestration (counterpart of
rtxpt_tpu/models/renderer.py; Sample.cpp Render/PathTrace, accumulation
Sample.cpp:1530-1566, 2469-2474).

Owns the device scene tables, the dense trace planes, the environment and
the light table on one torch device, and drives reference-mode
accumulation: chunks of up to 8 samples per pixel go through one
regenerating wavefront (integrator spp > 1), single samples through
`render_sample`.

The port builds only the dense trace planes (ops/mt_dense.py), which
serve every trace of scenes up to 8192 triangles; it refuses larger,
textured or alpha-MASK scenes until the BVH and texture paths are ported.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import config as C
from ..ops import mt_dense
from ..post import accumulation, tonemap
from ..pt import integrator
from ..scene import envmap as EM
from ..scene import lights as LI
from ..scene.build import to_device
from ..scene.camera import CameraData

REGEN_CHUNK = 8


def reference_config(**overrides) -> C.PTConfig:
    """Reference (accumulation) mode defaults (SampleUI.h:162-167)."""
    base = dict(max_bounces=30, max_diffuse_bounces=6,
                enable_russian_roulette=True)
    base.update(overrides)
    return C.PTConfig(**base)


def r2_jitter(index: int):
    """R2 low-discrepancy AA jitter in [-0.5, 0.5)^2."""
    a1, a2 = 0.7548776662466927, 0.5698402909980532
    return (((0.5 + a1 * index) % 1.0) - 0.5,
            ((0.5 + a2 * index) % 1.0) - 0.5)


def check_supported(host_scene: dict):
    """Raise NotImplementedError for scenes the port cannot render yet."""
    n_tris = host_scene["indices"].shape[0]
    if not mt_dense.supported(n_tris):
        raise NotImplementedError(
            f"{n_tris} triangles: scenes over {mt_dense.MAX_TRIS} need the "
            "BVH trace paths, which are not ported yet")
    if host_scene.get("texture_images"):
        raise NotImplementedError("textured scenes are not ported yet")
    if (np.asarray(host_scene["materials"]["alpha_mode"]) == 1).any():
        raise NotImplementedError("alpha-MASK materials need the exact "
                                  "alpha visibility path (not ported yet)")


class Renderer:
    def __init__(self, host_scene: dict, camera: CameraData,
                 cfg: Optional[C.PTConfig] = None, env_radiance=None,
                 device="cpu"):
        check_supported(host_scene)
        self.device = torch.device(device)
        self.cfg = cfg or reference_config()
        self.camera = camera.to(self.device)
        self.host_scene = host_scene
        self.scene = to_device(host_scene, self.device)
        if env_radiance is None:
            env_radiance = EM.bake_procedural_sky()
        self.env = EM.make_envmap(env_radiance,
                                  enabled=self.cfg.use_env_lights,
                                  device=self.device)
        self.lights = (LI.build_light_table(host_scene, device=self.device)
                       if self.cfg.use_emissive_lights else None)
        self.dense = mt_dense.build_dense(host_scene["positions"],
                                          host_scene["indices"],
                                          device=self.device)
        self.assets = integrator.RenderAssets(
            scene=self.scene, env=self.env, lights=self.lights,
            dense=self.dense)
        # accumulation state (resumable: buffer + index are the checkpoint)
        self.accum = None
        self.sample_index = 0

    def _pixel_grid(self, width: int, height: int):
        yy, xx = np.mgrid[0:height, 0:width]
        t = lambda a: torch.as_tensor(a.reshape(-1).astype(np.int64),
                                      device=self.device)
        return t(xx), t(yy)

    def _camera(self, width: int, height: int, jitter):
        return self.camera._replace(
            jitter=torch.tensor(jitter, dtype=torch.float32,
                                device=self.device),
            viewport=torch.tensor([width, height], dtype=torch.float32,
                                  device=self.device))

    def render_sample(self, width: int, height: int, sample_index: int,
                      jitter_aa: bool = True):
        """One sample per pixel at the given accumulation index."""
        px, py = self._pixel_grid(width, height)
        cam = self._camera(width, height, r2_jitter(sample_index)
                           if jitter_aa else (0.0, 0.0))
        radiance = integrator.render_wavefront(
            self.assets, cam, px, py,
            C.default_constants(sample_base_index=sample_index),
            cfg=self.cfg)
        return radiance.reshape(height, width, 3)

    def render(self, width: int, height: int, spp: int,
               jitter_aa: bool = True, progress=None):
        """Reference-mode accumulation of `spp` samples -> HDR (H,W,3)."""
        if self.accum is None:
            self.accum = torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=self.device)
            self.sample_index = 0
        remaining = spp
        while remaining > 0:
            # path regeneration (integrator spp > 1): dead lanes start
            # their pixel's next sample in place, keeping the wavefront
            # occupied; it jitters each regenerated sample itself
            if jitter_aa and remaining >= 2:
                k = min(remaining, REGEN_CHUNK)
                px, py = self._pixel_grid(width, height)
                cam = self._camera(width, height,
                                   r2_jitter(self.sample_index))
                total = integrator.render_wavefront(
                    self.assets, cam, px, py,
                    C.default_constants(sample_base_index=self.sample_index),
                    cfg=self.cfg, spp=k)
                n0 = self.sample_index
                self.accum = (self.accum * n0
                              + total.reshape(height, width, 3)) / (n0 + k)
                self.sample_index += k
                remaining -= k
            else:
                s = self.render_sample(width, height, self.sample_index,
                                       jitter_aa)
                self.accum = accumulation.accumulate(self.accum, s,
                                                     self.sample_index)
                self.sample_index += 1
                remaining -= 1
            if progress is not None:
                progress(self.sample_index)
        return self.accum

    def reset_accumulation(self):
        self.accum = None
        self.sample_index = 0

    # checkpoint/resume: reference-mode accumulation is resumable by
    # construction (buffer + sample index)
    def save_checkpoint(self, path: str):
        if self.accum is None:
            return
        np.savez(path, accum=self.accum.cpu().numpy(),
                 sample_index=self.sample_index)

    def load_checkpoint(self, path: str) -> bool:
        if not os.path.exists(path):
            return False
        data = np.load(path)
        self.accum = torch.as_tensor(data["accum"], device=self.device)
        self.sample_index = int(data["sample_index"])
        return True

    def tonemapped(self, hdr, exposure: float = 1.0,
                   auto_expose: bool = True):
        return tonemap.tonemap(hdr, exposure=exposure,
                               auto_expose=auto_expose)
