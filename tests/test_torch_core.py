"""bre_tpu_torch core vs bre_tpu: PCG32, sampling warps, transforms, camera
rays, Morton codes — identical numpy inputs through both packages.

Tolerances: integer and RNG streams are compared bit for bit.  Float warps
use rtol 1e-6 (the two frameworks' sin/cos/sqrt differ in the last ulp,
measured ~5-10% of lanes) and atol 2e-6; camera rays use rtol 1e-6 with
atol 1e-7 for the near-zero components."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bre_tpu.accel import lbvh as jlbvh
from bre_tpu.core import rng as jrng
from bre_tpu.core import sampling as jsamp
from bre_tpu.core import transform as jtfm
from bre_tpu.scene import camera as jcam
from bre_tpu_torch.accel import lbvh as tlbvh
from bre_tpu_torch.core import rng as trng
from bre_tpu_torch.core import sampling as tsamp
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.core.samplers import stream_1d
from bre_tpu_torch.scene import camera as tcam
from torch_parity import to_np

REPO = Path(__file__).resolve().parent.parent


def test_pcg32_streams_bit_exact():
    """u32 and f32 draws equal the reference bit for bit, including sequence
    indices with the high bits set (a non-logical shift or a signed
    multiply would break those first)."""
    seq = np.array([0, 1, 2, 7, 12345, 2**31 - 1, 2**31, 2**31 + 5,
                    0xDEADBEEF, 2**32 - 1], np.uint32)
    seq = np.concatenate([seq, np.random.RandomState(0).randint(
        0, 2**32, 200, dtype=np.uint64).astype(np.uint32)])
    sj = jrng.pcg32_init(jnp.asarray(seq))
    st = trng.pcg32_init(torch.from_numpy(seq.astype(np.int64)))
    for _ in range(40):
        sj, uj = jrng.pcg32_next_u32(sj)
        st, ut = trng.pcg32_next_u32(st)
        np.testing.assert_array_equal(to_np(uj).astype(np.int64), to_np(ut))
        sj, fj = jrng.pcg32_next_f32(sj)
        st, ft = trng.pcg32_next_f32(st)
        assert ft.dtype == torch.float32
        np.testing.assert_array_equal(to_np(fj), to_np(ft))
    # stream_1d on a bare state is pcg32_next_f32
    s2 = trng.pcg32_init(torch.arange(8))
    _, a = stream_1d(s2)
    _, b = trng.pcg32_next_f32(s2)
    assert torch.equal(a, b)


_U = np.random.RandomState(3).rand(4096, 2).astype(np.float32)
_U[:4] = [[0.5, 0.5], [0.0, 0.3], [0.999, 0.0], [0.5, 0.25]]  # edge cases


@pytest.mark.parametrize("name", ["uniform_sample_sphere",
                                  "concentric_sample_disk",
                                  "cosine_sample_hemisphere",
                                  "uniform_sample_triangle"])
def test_sampling_warps_match(name):
    j = to_np(getattr(jsamp, name)(jnp.asarray(_U)))
    t = to_np(getattr(tsamp, name)(torch.from_numpy(_U)))
    assert t.dtype == np.float32
    # atol: cosine_sample_hemisphere's z = sqrt(1 - x^2 - y^2) cancels near
    # the rim, where one ulp of x or y moves z by ~1e-6
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=2e-6)


def test_distribution_1d_and_sample_discrete():
    """CDF build and the FindInterval search: indices equal, pdfs to f32
    rounding; the all-zero distribution falls back to uniform."""
    for func in (np.array([0.3, 0.0, 2.5, 1.2, 0.01], np.float32),
                 np.zeros(4, np.float32)):
        dj = jsamp.make_distribution_1d(jnp.asarray(func))
        dt = tsamp.make_distribution_1d(torch.from_numpy(func))
        np.testing.assert_allclose(to_np(dt.cdf), to_np(dj.cdf), rtol=1e-6)
        u = np.concatenate([_U[:, 0], to_np(dj.cdf)[:-1]]).astype(np.float32)
        ij, pj = jsamp.sample_discrete(dj, jnp.asarray(u))
        it, pt = tsamp.sample_discrete(dt, torch.from_numpy(u))
        np.testing.assert_array_equal(to_np(it), to_np(ij))
        np.testing.assert_allclose(to_np(pt), to_np(pj), rtol=1e-6)


def test_transforms_and_camera_rays():
    """look_at / perspective / camera matrices are built with the same numpy
    arithmetic (bit-equal); generated rays agree to f32 rounding."""
    args = ((0, 0.3, -2.2), (0.1, 0, 1), (0, 1, 0))
    c2w_j = jtfm.look_at(*args)
    c2w_t = ttfm.look_at(*args)
    np.testing.assert_array_equal(to_np(c2w_t), to_np(c2w_j))
    np.testing.assert_array_equal(to_np(ttfm.perspective(50.0, 1e-2, 1e3)),
                                  to_np(jtfm.perspective(50.0, 1e-2, 1e3)))
    W, H = 24, 16
    cj = jcam.make_perspective_camera(c2w_j, 50.0, W, H)
    ct = tcam.make_perspective_camera(c2w_t, 50.0, W, H, device="cpu")
    np.testing.assert_array_equal(to_np(ct.raster_to_camera),
                                  to_np(cj.raster_to_camera))
    pj = jcam.pixel_centers(W, H)
    pt = tcam.pixel_centers(W, H)
    np.testing.assert_array_equal(to_np(pt), to_np(pj))
    jit = np.random.RandomState(1).rand(W * H, 2).astype(np.float32) - 0.5
    oj, dj = jcam.generate_rays(cj, pj + jnp.asarray(jit))
    ot, dt = tcam.generate_rays(ct, pt + torch.from_numpy(jit))
    np.testing.assert_allclose(to_np(ot), to_np(oj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_np(dt), to_np(dj), rtol=1e-6, atol=1e-7)


def test_morton3_bit_exact():
    p = np.random.RandomState(2).rand(5000, 3).astype(np.float32)
    p[:3] = [[0, 0, 0], [1, 1, 1], [0.999, 0.5, 1e-7]]
    j = to_np(jlbvh.morton3(jnp.asarray(p))).astype(np.int64)
    t = to_np(tlbvh.morton3(torch.from_numpy(p)))
    np.testing.assert_array_equal(t, j)


def test_port_imports_no_jax():
    """bre_tpu_torch and the card scripts never import JAX or bre_tpu."""
    pat = re.compile(r"^\s*(import\s+(jax|bre_tpu)\b|from\s+(jax|bre_tpu)\b)",
                     re.M)
    files = sorted((REPO / "bre_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "profile_step.py"]
    assert len(files) > 15
    for f in files:
        assert not pat.search(f.read_text()), f"{f} imports jax or bre_tpu"
