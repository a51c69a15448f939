"""The check that decides `correct` in reference mode.

The port's accumulated image is compared, at pixels drawn from the seed,
with the plain reference (`refpt`, a frozen copy of the port's plain
path tracer over the benchmark's own brute-force trace). A render's
random streams are keyed by (pixel, path vertex, sample index), so the
reference replays exactly the samples that the window's render calls
took, for the drawn pixels only: one wavefront whose lanes are (pixel,
call) pairs, each with its call's sample base and camera jitter, then the
port's running mean over the calls. Where the two agree, a pixel agrees
to rounding; a pixel is "off" where it differs by more than the
tolerance, as when one of its paths parted from the reference's.

The number compared is the share of drawn pixels that are off. Its limit
and the readings it was set from are in PERF.md.

The control: the same reference with the scene's geometry, the
environment and every ray and hit through the trace rounded to bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from refpt import config as RC
from refpt.core import mathutils as RMU
from refpt.ops import traverse as RT
from refpt.pt import integrator as RI
from refpt.scene import build as RB
from refpt.scene import camera as RCAM
from refpt.scene import envmap as REM
from refpt.scene import lights as RL
from refpt.scene import textures as RTX

REGEN_CHUNK = 8        # the port's samples per regenerating wavefront
# a pixel is off where a channel differs by more than RTOL of the
# reference's value plus ATOL
RTOL = 1e-3
ATOL = 1e-5
# the limit on the share of drawn pixels that are off (PERF.md gives the
# readings it was set from)
LIMITS = {"pixels_off_share": 0.02}


def draw_pixels(rng: np.random.Generator, width: int, height: int,
                count: int) -> np.ndarray:
    """Flat indices of `count` distinct pixels."""
    return rng.choice(width * height, size=min(count, width * height),
                      replace=False)


def r2_jitter(index: int):
    """The port's R2 jitter of a render call's first samples."""
    a1, a2 = 0.7548776662466927, 0.5698402909980532
    return (((0.5 + a1 * index) % 1.0) - 0.5,
            ((0.5 + a2 * index) % 1.0) - 0.5)


def _bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def reference_pixels(host: dict, env_radiance, camera, settings: dict,
                     width: int, height: int, spp: int, calls: int,
                     pixels: np.ndarray, device, control: bool = False):
    """(P,3) float32: the accumulated image of `calls` render calls of
    `spp` samples each at the flat pixel indices `pixels`, as the port
    accumulates it from sample index 0. camera = (eye, target, fov_y)."""
    if not 2 <= spp <= REGEN_CHUNK:
        raise ValueError(f"spp per call {spp} is not in [2, {REGEN_CHUNK}]")
    cfg = RC.PTConfig(**settings)
    if (np.asarray(host["materials"]["alpha_mode"]) == 1).any() \
            and host.get("texture_images"):
        raise ValueError("alpha-MASK textures need the exact alpha test of "
                         "visibility rays, which the plain reference lacks")
    if control:
        host = dict(host)
        for key in ("positions", "normals", "tangents", "uvs"):
            host[key] = _bf16(host[key])
        env_radiance = _bf16(env_radiance)
    env = REM.make_envmap(env_radiance, device=device)
    lights = RL.build_light_table(host, device=device)
    accel = RT.build_clusters(host["positions"], host["indices"], device)
    if control:
        accel.round_to = torch.bfloat16
    scene = RB.to_device(host, device, RTX.build_texture_stack(
        host.get("texture_images"), srgb=host.get("texture_srgb"),
        device=device))
    assets = RI.RenderAssets(scene=scene, env=env, lights=lights,
                             accel=accel)
    # lanes: pixels in the bounce loop's own (Morton) order, each pixel's
    # calls side by side, so that the loop's stable sort keeps them in place
    pix = torch.as_tensor(np.asarray(pixels, np.int64))
    key = RMU.morton2d(pix % width, pix // width)
    order = torch.argsort(key, stable=True)
    pix_sorted = pix[order]
    lane_pix = pix_sorted.repeat_interleave(calls)
    lane_call = torch.arange(calls).repeat(pix.numel())
    px = (lane_pix % width).to(device)
    py = (lane_pix // width).to(device)
    base = (lane_call * spp).to(torch.int64)
    jit = torch.tensor([r2_jitter(j * spp) for j in range(calls)],
                       dtype=torch.float32)[lane_call]
    eye, target, fov_y = camera
    cam = RCAM.look_at(width, height, eye, target, fov_y=fov_y).to(device)
    cam = cam._replace(jitter=jit.to(device))
    consts = RC.PTConstants(sample_base_index=base.to(device))
    total = RI.render_wavefront(assets, cam, px, py, consts, cfg=cfg,
                                spp=spp)
    total = total.reshape(pix.numel(), calls, 3)
    accum = torch.zeros((pix.numel(), 3), dtype=torch.float32,
                        device=total.device)
    for j in range(calls):
        n0 = j * spp
        accum = (accum * n0 + total[:, j]) / (n0 + spp)
    out = torch.empty_like(accum)
    out[order.to(accum.device)] = accum
    return out.cpu()


def compare(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """The numbers compared, and some beside them for the record."""
    p = program.to(torch.float64)
    r = reference.to(torch.float64)
    diff = (p - r).abs()
    off = (diff > RTOL * r.abs() + ATOL).any(-1) | ~torch.isfinite(p).all(-1)
    rel = diff / (r.abs() + ATOL)
    return {"pixels_off_share": float(off.to(torch.float64).mean()),
            "max_rel_diff": float(torch.nan_to_num(rel, nan=np.inf).max()),
            "pixels": int(p.shape[0])}


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
