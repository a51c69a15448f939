"""The inputs of a cell, made by the benchmark and handed to both sides:
the host scene (numpy arrays), the environment's radiance and the camera's
eye, target and field of view, all from the configuration file. The seed
draws only the pixels that the correctness check compares: every seed
renders the same frames with the same work."""
from __future__ import annotations

import math

import numpy as np

from refpt.scene import envmap as REF_EM
from refpt.scene import procedural as REF_PROC


def seed_rng(seed: int) -> np.random.Generator:
    """The generator of everything a run draws from its seed."""
    return np.random.default_rng(int(seed) % (1 << 64))


def host_scene(config: dict) -> dict:
    """The scene's host arrays, from the configuration's builder."""
    sc = config["scene"]
    return getattr(REF_PROC, sc["builder"])(**sc.get("kwargs", {})).finish()


def env_radiance(config: dict) -> np.ndarray:
    return REF_EM.bake_procedural_sky(height=int(config["env"]["sky_rows"]))


def camera(config: dict):
    """(eye, target, fov_y in radians) of the configuration's camera."""
    cam = config["camera"]
    return (tuple(float(v) for v in cam["eye"]),
            tuple(float(v) for v in cam["target"]),
            math.radians(float(cam["fov_y_deg"])))

