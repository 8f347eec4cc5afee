"""bre_tpu_torch.core.animated and the camera's motion against bre_tpu's,
on the same numpy inputs from a seed.

- ``decompose`` (a float64 polar iteration on the host) and
  ``make_animated_transform``'s keyframes bit for bit;
  ``quat_from_matrix`` bit for bit.
- ``slerp``, ``quat_to_matrix``, ``interpolate`` (the keyframes' own
  matrices exactly at the ends of the shutter), ``motion_bounds``,
  ``apply_animated_point`` / ``_vector`` and ``generate_rays_animated``
  with ``shutter_times``: atol 2e-6 of max(|x|, 1) (XLA:CPU contracts
  multiply-adds in the matrix products; arccos, sin and cos round in
  their own ways).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bre_tpu.core import animated as ja
from bre_tpu.scene import camera as jc
from bre_tpu_torch.core import animated as ta
from bre_tpu_torch.core import transform as tfm
from bre_tpu_torch.scene import camera as tc
from torch_parity import to_np

R = 2048


def _close(a, b, atol=2e-6):
    b = np.asarray(b)
    np.testing.assert_allclose(to_np(a), b, rtol=0,
                               atol=atol * max(float(np.abs(b).max()), 1.0))


def _keyframes(flip=False):
    m0 = (tfm.translate((0.2, -0.1, 0.5)).numpy()
          @ tfm.rotate(20.0, (0.3, 1.0, 0.2)).numpy()
          @ tfm.scale(1.2, 0.9, 1.0).numpy())
    m1 = (tfm.translate((0.6, 0.3, 0.1)).numpy()
          @ tfm.rotate(-35.0 if not flip else 200.0, (0.1, 0.7, 0.5)).numpy()
          @ tfm.scale(1.0, 1.1, 0.8).numpy())
    return m0.astype(np.float32), m1.astype(np.float32)


@pytest.mark.parametrize("flip", [False, True])
def test_decompose_and_keyframes_bit_for_bit(flip):
    m0, m1 = _keyframes(flip)
    for m in (m0, m1):
        for a, b in zip(ta.decompose(m), ja.decompose(m)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ta.quat_from_matrix(m),
                                      ja.quat_from_matrix(m))
    mine = ta.make_animated_transform(m0, m1, 0.25, 0.75)
    ref = ja.make_animated_transform(m0, m1, 0.25, 0.75)
    for name in ("trans0", "trans1", "q0", "q1", "s0", "s1", "m_start",
                 "m_end"):
        np.testing.assert_array_equal(to_np(getattr(mine, name)),
                                      np.asarray(getattr(ref, name)), name)
    assert (mine.t0, mine.t1) == (float(ref.t0), float(ref.t1))
    assert mine.animated == bool(ref.animated)


@pytest.fixture(scope="module")
def pair():
    m0, m1 = _keyframes(True)
    return (ta.make_animated_transform(m0, m1, 0.25, 0.75),
            ja.make_animated_transform(m0, m1, 0.25, 0.75))


def test_slerp_quat_and_interpolate_match_jax(pair):
    mine, ref = pair
    rs = np.random.RandomState(0)
    t = rs.uniform(0, 1, R).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    q = ta.slerp(mine.q0, mine.q1, T(t))
    _close(q, ja.slerp(ref.q0, ref.q1, J(t)))
    _close(ta.quat_to_matrix(q), ja.quat_to_matrix(J(to_np(q))))
    times = rs.uniform(0.0, 1.0, R).astype(np.float32)
    times[:4] = (0.25, 0.75, 0.0, 1.0)  # the ends and past them
    M = ta.interpolate(mine, T(times))
    _close(M, ja.interpolate(ref, J(times)))
    for k, key in ((0, "m_start"), (1, "m_end"), (2, "m_start"),
                   (3, "m_end")):
        assert torch.equal(M[k], getattr(mine, key))


def test_motion_bounds_and_apply_match_jax(pair):
    mine, ref = pair
    lo, hi = ta.motion_bounds(mine, (-0.5, -0.2, 0.0), (0.5, 0.3, 1.0))
    jlo, jhi = ja.motion_bounds(ref, jnp.asarray([-0.5, -0.2, 0.0]),
                                jnp.asarray([0.5, 0.3, 1.0]))
    _close(lo, jlo, 1e-5)
    _close(hi, jhi, 1e-5)
    rs = np.random.RandomState(1)
    t = rs.uniform(0.25, 0.75, R).astype(np.float32)
    p = rs.normal(size=(R, 3)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(ta.apply_animated_point(mine, T(t), T(p)),
           ja.apply_animated_point(ref, J(t), J(p)))
    _close(ta.apply_animated_vector(mine, T(t), T(p)),
           ja.apply_animated_vector(ref, J(t), J(p)))


@pytest.mark.parametrize("kind", ["perspective", "realistic"])
def test_generate_rays_animated_matches_jax(kind):
    """Motion-blurred camera rays: the camera-space rays (a pinhole, and
    the realistic camera's traced and weighted ones) through the animated
    camera-to-world at each ray's shutter time."""
    m0, m1 = _keyframes()
    mine = ta.make_animated_transform(m0, m1, 0.0, 1.0)
    ref = ja.make_animated_transform(m0, m1, 0.0, 1.0)
    if kind == "perspective":
        cam = tc.make_perspective_camera(np.eye(4), 45.0, 16, 12,
                                         device="cpu")
        jcam = jc.make_perspective_camera(np.eye(4), 45.0, 16, 12)
    else:
        rows = [[50.0, 5.0, 1.5, 30.0], [0.0, 2.0, 0.0, 6.0],
                [-50.0, 45.0, 1.0, 30.0]]
        cam = tc.make_realistic_camera(np.eye(4), rows, 16, 12,
                                       aperture_diameter=20.0,
                                       focus_distance=2.0, device="cpu")
        jcam = jc.make_realistic_camera(np.eye(4), rows, 16, 12,
                                        aperture_diameter=20.0,
                                        focus_distance=2.0)
    rs = np.random.RandomState(2)
    p = (rs.uniform(0, 1, (R, 2)) * (16, 12)).astype(np.float32)
    u_time = rs.uniform(0, 1, R).astype(np.float32)
    u_lens = rs.uniform(0, 1, (R, 2)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    times = tc.shutter_times(0.1, 0.9, T(u_time))
    _close(times, jc.shutter_times(0.1, 0.9, J(u_time)))
    got = tc.generate_rays_animated(cam, mine, T(p), times, T(u_lens))
    want = jc.generate_rays_animated(jcam, ref, J(p), J(to_np(times)),
                                     J(u_lens))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    ok = to_np(got[2]) > 0
    assert ok.sum() > R // 10
    for a, b in zip(got[:2], want[:2]):
        _close(to_np(a)[ok], np.asarray(b)[ok], 2e-5)
