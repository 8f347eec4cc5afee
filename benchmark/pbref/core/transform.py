"""4x4 transforms (counterpart of ``bre_tpu/core/transform.py``).

``translate``, ``scale``, ``rotate``, ``look_at`` and ``perspective`` build
their matrices in numpy exactly as the reference does (float64 where it
uses float64, rounded to float32 at the same points) and return float32 CPU
tensors, so the scene parser's CTM is bit for bit the reference's;
``apply_point``/``apply_vector`` apply them to batches.
"""

from __future__ import annotations

import numpy as np
import torch


def translate(delta) -> torch.Tensor:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(delta, np.float32)
    return torch.from_numpy(m)


def scale(sx, sy=None, sz=None) -> torch.Tensor:
    if sy is None:
        sy = sz = sx
    return torch.from_numpy(np.diag(np.array([sx, sy, sz, 1.0], np.float32)))


def rotate(deg: float, axis) -> torch.Tensor:
    """Rotation about an arbitrary axis (pbrt transform.cpp:140-170)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    t = np.deg2rad(deg)
    s, c = np.sin(t), np.cos(t)
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return torch.from_numpy(m.astype(np.float32))


def look_at(pos, look, up) -> torch.Tensor:
    """Camera-to-world (pbrt transform.cpp:172-197)."""
    pos = np.asarray(pos, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - pos
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = pos
    return torch.from_numpy(m.astype(np.float32))


def perspective(fov_deg: float, near: float, far: float) -> torch.Tensor:
    """Projective camera->screen (pbrt transform.cpp Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ],
        np.float32,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    return torch.from_numpy(
        np.diag([inv_tan, inv_tan, 1.0, 1.0]).astype(np.float32) @ persp)


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply to points (w=1) with the perspective divide; batched over p."""
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    w = w[..., None]
    return r / torch.where(w.abs() > 0, w, torch.ones_like(w))


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply to vectors (w=0)."""
    return v @ m[:3, :3].T
