"""Renderer: reference-mode frame orchestration (counterpart of
rtxpt_tpu/models/renderer.py; Sample.cpp Render/PathTrace, accumulation
Sample.cpp:1530-1566, 2469-2474).

Owns the device scene tables, the trace structure, the environment and
the light table on one torch device, and drives reference-mode
accumulation: chunks of up to 8 samples per pixel go through one
regenerating wavefront (integrator spp > 1), single samples through
`render_sample`. Configurations whose assets change with each sample
(ReGIR local sampling rebuilds its light grid, the presampled distant
sampler its env list) render sample by sample.

The trace structure is the reference's tier for the scene's size, and
only that one is built: the dense planes (ops/mt_dense.py) up to 8,192
triangles, a single BVH8 (ops/bvh.py) up to 45,000, the two-level BVH8
(ops/bvh2l.py) above, or the instanced TLAS (ops/instanced.py) for a
rigid-animated scene above 45,000 (`build_trace_structure`). (The
reference also builds a BVH2 and a triangle soup that nothing traces.)
`animate` poses a glTF scene's skins and node animations
(scene/animation.py) and replaces the tables, the trace structure and the
light rows. Alpha-MASK triangles carry their opacity micro-masks
(scene/omm.py, baked from the base color's alpha) into whichever tier is
built; the texture stack (scene/textures.py) is built after it, so that
the other glTF images, decoding on the texture cache's threads, overlap
the build.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .. import config as C
from ..ops import bvh as bvh_mod
from ..ops import bvh2l, instanced, mt_dense
from ..post import accumulation, tonemap
from ..pt import integrator
from ..restir import regir as RG
from ..scene import animation as AN
from ..scene import envmap as EM
from ..scene import lights as LI
from ..scene import omm as OMM
from ..scene import textures as TX
from ..scene import types as ST
from ..scene.build import to_device
from ..scene.camera import CameraData
from ..utils import profiling

REGEN_CHUNK = 8
BVH8_MAX_TRIS = 45_000    # above this the two-level BVH8 takes over
# the instanced gate's limits (rtxpt_tpu/models/renderer.py:105-118)
INSTANCED_MAX_INSTANCES = 8192
INSTANCED_MAX_MESH_TRIS = 25_000


def reference_config(**overrides) -> C.PTConfig:
    """Reference (accumulation) mode defaults (SampleUI.h:162-167)."""
    base = dict(mode=C.MODE_REFERENCE, max_bounces=30,
                max_diffuse_bounces=6, enable_russian_roulette=True)
    base.update(overrides)
    return C.PTConfig(**base)


def realtime_config(**overrides) -> C.PTConfig:
    """Real-time mode defaults (SampleUI.h:158-168)."""
    base = dict(mode=C.MODE_REFERENCE, max_bounces=30,
                max_diffuse_bounces=3, enable_russian_roulette=True,
                use_restir_di=False, use_restir_gi=False)
    base.update(overrides)
    return C.PTConfig(**base)


def r2_jitter(index: int):
    """R2 low-discrepancy AA jitter in [-0.5, 0.5)^2."""
    a1, a2 = 0.7548776662466927, 0.5698402909980532
    return (((0.5 + a1 * index) % 1.0) - 0.5,
            ((0.5 + a2 * index) % 1.0) - 0.5)


def has_mask_materials(host_scene: dict) -> bool:
    """Whether the scene has an alpha-MASK material and textures: the
    reference's condition for the exact alpha test
    (rtxpt_tpu/models/renderer.py:81-88)."""
    return bool((np.asarray(host_scene["materials"]["alpha_mode"]) == 1)
                .any()) and bool(host_scene.get("texture_images"))


def uses_instanced(host_scene: dict) -> bool:
    """The reference's instanced gate (rtxpt_tpu/models/renderer.py:
    105-118) without its environment switch: the scene carries instancing
    and no skin, has over 45,000 triangles and animated nodes (the glTF
    loader's `animations`), at most 8,192 instances and no mesh over
    25,000 triangles. A static scene takes the two-level BVH8, which the
    reference measured faster; the instanced TLAS is the large-scene
    structure with a rigid-motion update path."""
    inst = host_scene.get("instancing")
    return (inst is not None and not host_scene.get("skin_bindings")
            and host_scene["indices"].shape[0] > BVH8_MAX_TRIS
            and bool(host_scene.get("animations"))
            and len(inst["mesh_of_instance"]) <= INSTANCED_MAX_INSTANCES
            and max(m["indices"].shape[0] for m in inst["meshes"])
            <= INSTANCED_MAX_MESH_TRIS)


def build_trace_structure(host_scene: dict, device, tri_omm=None):
    """The trace structure of the reference's tier for the scene's
    triangle count (rtxpt_tpu/models/renderer.py:105-148), with the
    triangles' opacity masks `tri_omm` (scene/omm.py): a DenseMT, an
    InstancedTL (`uses_instanced`; its leaves carry no masks, as in the
    reference), a BVH8 or a BVH8TwoLevel."""
    pos, idx = host_scene["positions"], host_scene["indices"]
    n_tris = idx.shape[0]
    if mt_dense.supported(n_tris):
        return mt_dense.build_dense(pos, idx, tri_omm=tri_omm, device=device)
    if uses_instanced(host_scene):
        return instanced.build_instanced(host_scene["instancing"], device)
    if n_tris <= BVH8_MAX_TRIS:
        return bvh_mod.collapse_bvh8(bvh_mod.build_bvh(pos, idx), pos, idx,
                                     tri_omm=tri_omm, device=device)
    return bvh2l.build_two_level(pos, idx, tri_omm=tri_omm, device=device)


class Renderer:
    def __init__(self, host_scene: dict, camera: CameraData,
                 cfg: Optional[C.PTConfig] = None, env_radiance=None,
                 analytic_lights=None, env_intensity: float = 1.0,
                 device="cuda"):
        """analytic_lights: the scene loaders' point, spot, directional
        and sphere lights (scene/lights.py); env_intensity scales the
        environment."""
        self.device = torch.device(device)
        self.cfg = cfg or reference_config()
        # the exact alpha re-test matters only where MASK materials exist
        if self.cfg.exact_alpha_test and not has_mask_materials(host_scene):
            self.cfg = dataclasses.replace(self.cfg, exact_alpha_test=False)
        self.camera = camera.to(self.device)
        self.host_scene = host_scene
        dev = self.device
        with profiling.span("build/env", sync_on=dev):
            if env_radiance is None:
                env_radiance = EM.bake_procedural_sky()
            self.env = EM.make_envmap(env_radiance, intensity=env_intensity,
                                      enabled=self.cfg.use_env_lights,
                                      device=dev)
        # the analytic lights stay for the light-table rebuild of an
        # emissive edit (set_material)
        self.analytic_lights = analytic_lights
        with profiling.span("build/lights", sync_on=dev):
            self.lights = (LI.build_light_table(host_scene, analytic_lights,
                                                device=dev)
                           if self.cfg.use_emissive_lights else None)
        with profiling.span("build/omm", sync_on=dev):
            tri_omm = OMM.bake_opacity_masks(host_scene)
        with profiling.span("build/accel", sync_on=dev):
            self.accel = build_trace_structure(host_scene, dev, tri_omm)
        with profiling.span("build/tables", sync_on=dev):
            self.scene = to_device(host_scene, dev, TX.build_texture_stack(
                host_scene.get("texture_images"),
                srgb=host_scene.get("texture_srgb"), device=dev))
            tri_omm = torch.as_tensor(tri_omm, device=dev)
        self.assets = integrator.RenderAssets(
            scene=self.scene, env=self.env, lights=self.lights,
            accel=self.accel, tri_omm=tri_omm)
        # accumulation state (resumable: buffer + index are the checkpoint)
        self.accum = None
        self.sample_index = 0
        self.posed = False            # animate() has moved the triangles

    def _pixel_grid(self, width: int, height: int):
        yy, xx = np.mgrid[0:height, 0:width]
        return self._to_device(xx.reshape(-1).astype(np.int64)), \
            self._to_device(yy.reshape(-1).astype(np.int64))

    def _to_device(self, values, dtype=None):
        """Host values as a tensor on the renderer's device: a host sync
        where that is a CUDA device."""
        with profiling.span("sync"):
            return torch.as_tensor(values, dtype=dtype, device=self.device)

    def _camera(self, width: int, height: int, jitter):
        f32 = torch.float32
        return self.camera._replace(
            jitter=self._to_device(jitter, f32),
            viewport=self._to_device([width, height], f32))

    def sample_assets(self, sample_index: int) -> integrator.RenderAssets:
        """The assets of one accumulation sample: with ReGIR local sampling
        the light grid built for it (grid or onion cells, the onion centred
        on the camera), with the presampled distant sampler its env list
        (rtxpt_tpu/models/renderer.py:203-218)."""
        assets = self.assets
        if self.cfg.nee_local_type == C.NEE_LOCAL_REGIR and \
                self.lights is not None:
            pos = self.scene.positions
            assets = dataclasses.replace(assets, regir=RG.build_regir(
                self.lights, pos.amin(0) - 1e-3, pos.amax(0) + 1e-3,
                sample_index, layout=self.cfg.regir_layout,
                center=self.camera.pos))
        if self.cfg.nee_distant_type == C.NEE_DISTANT_PRESAMPLED:
            assets = dataclasses.replace(
                assets, env_presampled=EM.presample(self.env, sample_index))
        return assets

    def render_sample(self, width: int, height: int, sample_index: int,
                      jitter_aa: bool = True):
        """One sample per pixel at the given accumulation index."""
        with profiling.span("entry"):
            px, py = self._pixel_grid(width, height)
            cam = self._camera(width, height, r2_jitter(sample_index)
                               if jitter_aa else (0.0, 0.0))
        radiance = integrator.render_wavefront(
            self.sample_assets(sample_index), cam, px, py,
            C.default_constants(sample_base_index=sample_index),
            cfg=self.cfg)
        return radiance.reshape(height, width, 3)

    def render(self, width: int, height: int, spp: int,
               jitter_aa: bool = True, progress=None):
        """Reference-mode accumulation of `spp` samples -> HDR (H,W,3), in
        one `render` span (the recorder's call)."""
        with profiling.span("render"):
            return self._render(width, height, spp, jitter_aa, progress)

    def _render(self, width: int, height: int, spp: int, jitter_aa: bool,
                progress):
        if self.accum is None:
            self.accum = torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=self.device)
            self.sample_index = 0
        # path regeneration (integrator spp > 1): dead lanes start their
        # pixel's next sample in place, keeping the wavefront occupied; it
        # jitters each regenerated sample itself. ReGIR and presampled
        # configurations render sample by sample, as in the reference
        # (rtxpt_tpu/models/renderer.py:245-252): their per-sample assets
        # would be stale on regenerated samples
        can_regen = (jitter_aa
                     and self.cfg.nee_local_type != C.NEE_LOCAL_REGIR
                     and self.cfg.nee_distant_type
                     != C.NEE_DISTANT_PRESAMPLED)
        remaining = spp
        while remaining > 0:
            if can_regen and remaining >= 2:
                k = min(remaining, REGEN_CHUNK)
                with profiling.span("entry"):
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

    def animate(self, info: dict, time: float, animation_index: int = 0):
        """Pose the glTF scene of `info` (gltf.load_gltf's) at `time`
        seconds of animation `animation_index` (Scene::Refresh and the
        skinned BLAS updates; rtxpt_tpu/models/renderer.py:334-359): the
        tables, the trace structure (refit, re-read or instance rows) and
        the light rows of emissive triangles are replaced, and later
        renders see the new pose. Accumulation is not reset."""
        self.scene, self.accel = AN.refresh_skinned(
            self.host_scene, info, self.scene, self.accel, time,
            animation_index)
        self.lights = LI.refresh_pack(self.lights, self.scene.positions,
                                      self.scene.indices)
        self.posed = True
        self.assets = dataclasses.replace(self.assets, scene=self.scene,
                                          accel=self.accel,
                                          lights=self.lights)

    def update_environment(self, env_radiance, intensity: float = 1.0):
        """Swap in a new environment (EnvMapBaker::Update, Sample.cpp:
        1495-1521): the importance pyramid and alias tables are rebuilt
        from the equirect radiance `env_radiance` on the renderer's device;
        an animated sun is `bake_procedural_sky(sun_dir=...)` fed here each
        frame. No other scene state is touched."""
        self.env = EM.make_envmap(env_radiance, intensity=intensity,
                                  enabled=self.cfg.use_env_lights,
                                  device=self.device)
        self.assets = dataclasses.replace(self.assets, env=self.env)

    def set_material(self, index: int, base_color=None, roughness=None,
                     metalness=None, emissive=None):
        """Live material edit (the SampleUI material editor,
        RTXPT/SampleUI.cpp:1254,1382): the material's row of `mat_pack`,
        which the surface fetch reads, is written in place on the device,
        so the table stays one contiguous (M, 46) tensor and nothing is
        rebuilt. An emissive edit also writes the host materials and
        rebuilds the light table with the scene's analytic lights (the
        reference's PrepareLightsPass runs every frame); on a posed scene
        the rebuilt rows take the posed triangles. Accumulation and the
        realtime histories are not reset."""
        mp = self.scene.mat_pack
        for col, val, k in ((ST.MP_BASE, base_color, 3),
                            (ST.MP_ROUGH, roughness, 1),
                            (ST.MP_METAL, metalness, 1),
                            (ST.MP_EMISSIVE, emissive, 3)):
            if val is not None:
                mp[index, col:col + k] = torch.as_tensor(
                    np.asarray(val, np.float32).reshape(k), device=mp.device)
        if emissive is not None and self.cfg.use_emissive_lights:
            mats = self.host_scene["materials"]
            mats["emissive"] = np.array(mats["emissive"])
            mats["emissive"][index] = np.asarray(emissive, np.float32)
            self.lights = LI.build_light_table(
                self.host_scene, self.analytic_lights, device=self.device)
            if self.posed:
                self.lights = LI.refresh_pack(
                    self.lights, self.scene.positions, self.scene.indices)
            self.assets = dataclasses.replace(self.assets,
                                              lights=self.lights)

    def material_info(self):
        """The editable material list of the UI: index, name, base
        colour, roughness, metalness and emission of every material, read
        from `mat_pack` in one copy to the host."""
        mp = self.scene.mat_pack.cpu().numpy()
        names = self.host_scene.get("material_names") or \
            [f"material {i}" for i in range(mp.shape[0])]
        return [dict(index=i, name=str(names[i]),
                     base_color=mp[i, ST.MP_BASE:ST.MP_BASE + 3].tolist(),
                     roughness=float(mp[i, ST.MP_ROUGH]),
                     metalness=float(mp[i, ST.MP_METAL]),
                     emissive=mp[i, ST.MP_EMISSIVE:ST.MP_EMISSIVE + 3]
                     .tolist())
                for i in range(mp.shape[0])]

    def tonemapped(self, hdr, exposure: float = 1.0,
                   auto_expose: bool = True):
        return tonemap.tonemap(hdr, exposure=exposure,
                               auto_expose=auto_expose)
