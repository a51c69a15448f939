"""Camera model: pinhole + thin lens with per-frame jitter (counterpart
of rtxpt_tpu/scene/camera.py; PathTracerShared.h:101-133 BridgeCamera,
PathTracerHelpers.hlsli:76-153 ComputeRayPinhole/ComputeRayThinlens)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import mathutils as mu
from ..core import raycone
from ..utils import profiling


class CameraData(NamedTuple):
    """PathTracerCameraData; every field a float32 tensor on one device."""
    pos: torch.Tensor            # (3,)
    direction: torch.Tensor      # (3,) normalized
    u: torch.Tensor              # (3,) scaled right vector
    v: torch.Tensor              # (3,) scaled up vector
    w: torch.Tensor              # (3,) dir * focalDistance
    viewport: torch.Tensor       # (2,) (width, height)
    jitter: torch.Tensor         # (2,)
    aperture_radius: torch.Tensor
    near_z: torch.Tensor
    far_z: torch.Tensor
    pixel_cone_spread_angle: torch.Tensor

    def to(self, device) -> "CameraData":
        return CameraData(*(f.to(device) for f in self))


def make_camera(width: int, height: int, pos, look_dir, up=(0.0, 1.0, 0.0),
                fov_y: float = math.radians(60.0), near_z: float = 0.001,
                far_z: float = 1e7, focal_distance: float = 1.0,
                aperture_radius: float = 0.0,
                jitter=(0.0, 0.0)) -> CameraData:
    """BridgeCamera (PathTracerShared.h:101-133)."""
    pos = np.asarray(pos, np.float32)
    d = np.asarray(look_dir, np.float32)
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    aspect = width / float(height)
    w = d * focal_distance
    u = np.cross(w, up)
    u = u / np.linalg.norm(u)
    v = np.cross(u, w)
    v = v / np.linalg.norm(v)
    ulen = focal_distance * math.tan(fov_y * 0.5) * aspect
    vlen = focal_distance * math.tan(fov_y * 0.5)
    spread = raycone.pixel_spread_angle(fov_y, height)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return CameraData(
        pos=f32(pos), direction=f32(d), u=f32(u * ulen), v=f32(v * vlen),
        w=f32(w), viewport=f32([width, height]), jitter=f32(jitter),
        aperture_radius=f32(aperture_radius), near_z=f32(near_z),
        far_z=f32(far_z), pixel_cone_spread_angle=f32(spread))


def look_at(width, height, eye, target, up=(0.0, 1.0, 0.0), **kw):
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    return make_camera(width, height, eye, target - eye, up, **kw)


def _ndc(cam: CameraData, pixel_x, pixel_y, jitter_x_sign: float):
    px = pixel_x.to(torch.float32) + 0.5 + jitter_x_sign * cam.jitter[0]
    py = pixel_y.to(torch.float32) + 0.5 + cam.jitter[1]
    p = torch.stack([px / cam.viewport[0], py / cam.viewport[1]], dim=-1)
    return torch.stack([2.0 * p[..., 0] - 1.0, -2.0 * p[..., 1] + 1.0],
                       dim=-1)


def compute_ray_pinhole(cam: CameraData, pixel_x, pixel_y):
    """Primary ray through pixel centers + jitter (Helpers.hlsli:97)."""
    ndc = _ndc(cam, pixel_x, pixel_y, 1.0)
    d = ndc[..., 0:1] * cam.u + ndc[..., 1:2] * cam.v + cam.w
    d = mu.normalize(d)
    origin = cam.pos.expand(d.shape)
    # the reference moves the origin to the near plane (Helpers:109-113)
    inv_cos = 1.0 / mu.dot(mu.normalize(cam.w[None]), d)
    return origin + d * (cam.near_z * inv_cos), d


def compute_ray_thinlens(cam: CameraData, pixel_x, pixel_y, u2):
    """Thin-lens ray with defocus (Helpers.hlsli:126-153); the reference
    flips the jitter sign in this path."""
    ndc = _ndc(cam, pixel_x, pixel_y, -1.0)
    d = ndc[..., 0:1] * cam.u + ndc[..., 1:2] * cam.v + cam.w
    origin = cam.pos.expand(d.shape)
    ap = mu.sample_disk_concentric(u2)
    target = origin + d
    un = mu.normalize(cam.u[None])
    vn = mu.normalize(cam.v[None])
    origin = origin + cam.aperture_radius * (
        ap[..., 0:1] * un + ap[..., 1:2] * vn)
    d = mu.normalize(target - origin)
    inv_cos = 1.0 / mu.dot(mu.normalize(cam.w[None]), d)
    return origin + d * (cam.near_z * inv_cos), d


def compute_rays(cam: CameraData, pixel_x, pixel_y, u2=None):
    """Thin lens when the camera has an aperture, else pinhole
    (Bridge::computeCameraRay, PathTracerBridgeDonut.hlsli:309)."""
    if u2 is not None:
        with profiling.span("sync"):
            thin = float(cam.aperture_radius) > 0.0
        if thin:
            return compute_ray_thinlens(cam, pixel_x, pixel_y, u2)
    return compute_ray_pinhole(cam, pixel_x, pixel_y)
