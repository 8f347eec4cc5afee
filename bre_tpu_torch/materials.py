"""BSDF sampling and evaluation, matte only (counterpart of
``bre_tpu/materials.py:204-237, 237-475, 478-594``; pbrt reflection.h
LambertianReflection).  Other materials are ROADMAP Queue 1 "breadth";
``scene.check_slice`` rejects them."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .core.math import (INV_PI, coordinate_system, cross, dot, face_forward,
                        length_squared, normalize)
from .core.sampling import cosine_hemisphere_pdf, cosine_sample_hemisphere
from .scene.scene import Materials

MODE_RADIANCE = 0
MODE_IMPORTANCE = 1


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # (R,3)
    f: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,)
    specular: torch.Tensor  # (R,) bool
    valid: torch.Tensor  # (R,) bool (false => terminate the path)


def _local_frame(ns):
    vx, vy = coordinate_system(ns)
    return vx, vy


def _to_world(w_local, vx, vy, ns):
    return normalize(w_local[:, 0:1] * vx + w_local[:, 1:2] * vy
                     + w_local[:, 2:3] * ns)


def sample_bsdf(materials: Materials, mat_idx: torch.Tensor, n: torch.Tensor,
                wo: torch.Tensor, u: torch.Tensor, mode: int = MODE_RADIANCE,
                tangent: Optional[torch.Tensor] = None) -> BSDFSample:
    """Batched BSDF::Sample_f for matte (cosine-sampled Lambertian,
    reflection.h:343-360) in pbrt's BSDF frame: ss = normalize(dpdu) from
    the unflipped normal, z on wo's side (reflection.h:429-438, 502-505).
    The matte lobe is symmetric, so ``mode`` does not change it."""
    R = mat_idx.shape[0]
    dev = n.device
    if materials.mtype.shape[0] == 0:
        z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        zb = torch.zeros((R,), dtype=torch.bool, device=dev)
        return BSDFSample(z3, z3, z3[:, 0], zb, zb)
    has_mat = mat_idx >= 0
    mi = torch.clamp(mat_idx, 0, materials.mtype.shape[0] - 1)
    kd = materials.kd[mi]

    ns = face_forward(n, wo)
    t_in = tangent if tangent is not None else torch.zeros_like(n)
    ss_raw = t_in - n * dot(t_in, n)[:, None]
    ss_len = torch.sqrt(length_squared(ss_raw))
    ss_ok = ss_len > 1e-6
    ss = ss_raw / torch.clamp_min(ss_len, 1e-12)[:, None]
    cvx, cvy = _local_frame(ns)
    vx = torch.where(ss_ok[:, None], ss, cvx)
    vy = torch.where(ss_ok[:, None], cross(n, ss), cvy)

    wl = cosine_sample_hemisphere(u)
    wi = _to_world(wl, vx, vy, ns)
    pdf = cosine_hemisphere_pdf(torch.clamp_min(wl[:, 2], 0.0))
    f = kd * INV_PI
    valid = has_mat & (pdf > 0.0) & (f.abs().sum(-1) > 0.0)
    specular = torch.zeros((R,), dtype=torch.bool, device=dev)
    return BSDFSample(wi=wi, f=f, pdf=pdf, specular=specular, valid=valid)


def eval_bsdf(materials: Materials, mat_idx, n, wo, wi):
    """Batched BSDF::f + Pdf for matte (reflection.cpp:617-637): (f, pdf),
    zero off the shared hemisphere and where there is no material."""
    if materials.mtype.shape[0] == 0:
        return (torch.zeros(mat_idx.shape + (3,), dtype=torch.float32,
                            device=n.device),
                torch.zeros(mat_idx.shape, dtype=torch.float32, device=n.device))
    has_mat = mat_idx >= 0
    mi = torch.clamp(mat_idx, 0, materials.mtype.shape[0] - 1)
    kd = materials.kd[mi]
    ns = face_forward(n, wo)
    cos_i = dot(wi, ns)
    same_hemi = (cos_i > 0.0) & (dot(wo, ns) > 0.0)
    f = kd * INV_PI
    pdf = cosine_hemisphere_pdf(torch.clamp_min(cos_i, 1e-6))
    ok = has_mat & same_hemi
    return (torch.where(ok[:, None], f, torch.zeros_like(f)),
            torch.where(ok, pdf, torch.zeros_like(pdf)))
