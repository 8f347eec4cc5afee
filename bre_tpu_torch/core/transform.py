"""4x4 transforms (counterpart of ``bre_tpu/core/transform.py``).

``look_at`` and ``perspective`` build their matrices in numpy exactly as the
reference does (float64 math, one float32 cast) and return float32 CPU
tensors; ``apply_point``/``apply_vector`` apply them to batches.
"""

from __future__ import annotations

import numpy as np
import torch


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
