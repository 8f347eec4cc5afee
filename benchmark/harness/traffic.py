"""What every mix kind draws with: independent random streams of one seed,
and the camera orbit that render users apply between renders.

A mix is a data file, ``traffic/<mix>.json``, whose ``kind`` names the
generator and runner that read it: ``kinds/<kind>.py``.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Independent streams of one seed; any integer seed, negative too."""
    return np.random.default_rng([seed & ((1 << 64) - 1), stream])


def orbit_eye(eye, look, up, deg: float):
    """The eye turned by ``deg`` about the axis through ``look`` along
    ``up``."""
    eye, look = np.asarray(eye, np.float64), np.asarray(look, np.float64)
    k = np.asarray(up, np.float64)
    k = k / np.linalg.norm(k)
    v = eye - look
    th = np.deg2rad(deg)
    v = (v * np.cos(th) + np.cross(k, v) * np.sin(th)
         + k * np.dot(k, v) * (1.0 - np.cos(th)))
    return tuple(float(c) for c in look + v)
