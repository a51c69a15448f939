"""The camera path of the realtime cells: the configuration's eye turned
about the target's vertical axis by `step_deg` a frame, the turn
reversing every `period` frames (0.25 degrees a frame and 60 frames: a
15 degree back-and-forth sweep). View `f` is fixed by `f` alone, so every
seed renders the same frames."""
from __future__ import annotations

import math

import numpy as np


def angle_deg(frame: int, step_deg: float = 0.25, period: int = 60) -> float:
    """The turn of view `frame`: a triangle wave from 0 to step x period."""
    phase = frame % (2 * period)
    return step_deg * (phase if phase <= period else 2 * period - phase)


def eye(eye0, target, frame: int, step_deg: float = 0.25,
        period: int = 60):
    """The eye of view `frame`, as a tuple of floats."""
    a = math.radians(angle_deg(frame, step_deg, period))
    e = np.asarray(eye0, np.float64) - np.asarray(target, np.float64)
    c, s = math.cos(a), math.sin(a)
    x, z = c * e[0] + s * e[2], -s * e[0] + c * e[2]
    return (float(target[0] + x), float(eye0[1]), float(target[2] + z))
