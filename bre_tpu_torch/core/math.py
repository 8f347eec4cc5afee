"""Vector math on ``(..., 3)`` float32 tensors (counterpart of
``bre_tpu/core/math.py``): no Point/Vector classes, a trailing 3-axis."""

from __future__ import annotations

import torch

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_2PI = 1.0 / (2.0 * PI)
INV_4PI = 1.0 / (4.0 * PI)
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0
SHADOW_EPSILON = 1e-4


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def absdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return dot(a, b).abs()


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return (v * v).sum(-1)


def length(v: torch.Tensor) -> torch.Tensor:
    # clamped inside the sqrt, as the reference (dead-lane autodiff guard)
    return torch.sqrt(torch.clamp_min(length_squared(v), 1e-30))


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(length(v), 1e-30)[..., None]


def face_forward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flip n into the hemisphere of v (pbrt geometry.h Faceforward)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1: torch.Tensor):
    """Orthonormal basis about v1 (pbrt geometry.h:236-246), branchless."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    cond = (x.abs() > y.abs())[..., None]
    inv_a = 1.0 / torch.sqrt(torch.clamp_min(x * x + z * z, 1e-30))
    inv_b = 1.0 / torch.sqrt(torch.clamp_min(y * y + z * z, 1e-30))
    zero = torch.zeros_like(x)
    v2a = torch.stack([-z, zero, x], -1) * inv_a[..., None]
    v2b = torch.stack([zero, z, -y], -1) * inv_b[..., None]
    v2 = torch.where(cond, v2a, v2b)
    return v2, cross(v1, v2)


def spherical_direction_basis(sin_theta, cos_theta, phi, x, y, z):
    """SphericalDirection w.r.t. a frame (pbrt geometry.h:287-292)."""
    return ((sin_theta * torch.cos(phi))[..., None] * x
            + (sin_theta * torch.sin(phi))[..., None] * y
            + cos_theta[..., None] * z)


def offset_ray_origin(p: torch.Tensor, n: torch.Tensor, d: torch.Tensor,
                      eps: float = SHADOW_EPSILON) -> torch.Tensor:
    """Offset a spawn point along the normal, scaled by |p| (the reference's
    fixed-epsilon float32 form)."""
    scale = torch.clamp_min(p.abs().amax(-1), 1.0)
    return p + (eps * scale)[..., None] * face_forward(n, d)
