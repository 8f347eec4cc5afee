"""vsppm in bre_tpu_torch against bre_tpu, on the CPU, with
``kernel="compat"`` (tests/test_torch_vsppm_physical.py holds the physical
kernel): the golden scene (a fog cube, a point light in it, a matte wall)
at 8x8, 200 photons per iteration, maxdepth 2, 2 iterations.

bre_tpu's ``render_vsppm`` jits one iteration whole (about 2 minutes of
XLA compile at this size on one core); the test runs it with its three
phases (camera pass, photon pass, splat gather) jitted one by one instead
(about 50 s, each compiled once), and the rest of its iteration eagerly:
the same code.

Tolerances and their reasons:
- Statistics (photon paths, overflow, medium interactions, visible points
  of each kind) and the gather's M and overflow: exact.  Both packages run
  the same PCG32 and Halton streams, the same stable sort and the same
  d^2 <= r^2 decisions.
- Images and the gather's Phi: rtol 1e-5 (atol 1e-7).  The port sums a
  cell's K slots at once where the reference adds them one by one, and
  XLA:CPU contracts multiply-adds (ROADMAP Queue 3); measured 5.7e-7.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import vsppm as jv
from bre_tpu.scene import camera as jcam
from bre_tpu.scene.parser import parse_file as jparse
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import extra as textra
from bre_tpu_torch.integrators import vsppm as tv
from bre_tpu_torch.scene import camera as tcam
from bre_tpu_torch.scene.parser import parse_file as tparse
from torch_parity import to_np

DATA = Path(__file__).parent / "data"
W = 8
LOOK = ((0, 0, -3.5), (0, 0, 0), (0, 1, 0))
CFG = dict(iterations=2, maxdepth=2, photonsperiteration=200, radius=0.25)
RTOL, ATOL = 1e-5, 1e-7


def golden_scenes():
    """(bre_tpu scene, camera; port scene, camera) of vsppm_golden.pbrt at
    W x W."""
    f = str(DATA / "vsppm_golden.pbrt")
    js = jparse(f).build()
    ts = tparse(f, device="cpu").build(device="cpu")
    jc = jcam.make_perspective_camera(jtfm.look_at(*LOOK), 45.0, W, W)
    tc = tcam.make_perspective_camera(ttfm.look_at(*LOOK), 45.0, W, W,
                                      device="cpu")
    return js, jc, ts, tc


def phase_jitted_render(js, jc, cfg):
    """bre_tpu's render_vsppm with its three phases jitted one by one (the
    closures hold the scene, camera and config), iteration glue eager.
    Returns (image, stats, the jitted splat gather)."""
    orig = (jv._camera_pass, jv._photon_pass, jv._splat_gather)
    cache = {}

    def camera_pass(scene, camera, w, h, it, c):
        f = cache.setdefault("camera", jax.jit(
            lambda i: orig[0](scene, camera, w, h, i, c)))
        return f(it)

    def photon_pass(scene, distr, it, p, c):
        f = cache.setdefault("photon", jax.jit(
            lambda i: orig[1](scene, distr, i, p, c)))
        return f(it)

    def splat_gather(vps, radii, pi_, materials, c):
        f = cache.setdefault("splat", jax.jit(
            lambda v, r, q: orig[2](v, r, q, materials, c)))
        # the first iteration's radii are weakly typed: one signature for
        # every iteration
        return f(vps, radii.astype(jnp.float32), pi_)

    shim = type("jax_shim", (), dict(jit=staticmethod(lambda f: f),
                                     device_get=staticmethod(jax.device_get),
                                     lax=jax.lax))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv, "jax", shim)
        mp.setattr(jv, "_camera_pass", camera_pass)
        mp.setattr(jv, "_photon_pass", photon_pass)
        mp.setattr(jv, "_splat_gather", splat_gather)
        img, stats = jv.render_vsppm(js, jc, W, W, cfg)
    return np.asarray(img), stats, cache["splat"]


def assert_render_matches(kernel, ref):
    js, jc, ts, tc = ref["scenes"]
    img, stats = tv.render_vsppm(ts, tc, W, W,
                                 tv.VSPPMConfig(kernel=kernel, **CFG))
    assert stats == ref["stats"]
    assert stats["medium_interactions"] > 0 and stats["vp_surface"] > 0
    np.testing.assert_allclose(to_np(img), ref["img"], rtol=RTOL, atol=ATOL)
    assert ref["img"].max() > 0


@pytest.fixture(scope="module")
def ref():
    scenes = golden_scenes()
    img, stats, splat = phase_jitted_render(
        scenes[0], scenes[1], jv.VSPPMConfig(kernel="compat", **CFG))
    return dict(scenes=scenes, img=img, stats=stats, splat=splat)


def test_vsppm_compat_matches_jax(ref):
    assert_render_matches("compat", ref)


def _fixed_gather_inputs(I):
    """64 visible points of each kind (and none) and I photon interactions
    in [-1,1]^3, 300 of them packed into one 0.05 cube so that its cell
    overflows the K = 64 cap."""
    rs = np.random.RandomState(9)
    R = W * W
    f = lambda *s: rs.uniform(-1, 1, s).astype(np.float32)  # noqa: E731
    n = f(R, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wo = f(R, 3)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    vps = dict(p=f(R, 3) * 0.9, wo=wo, beta=rs.rand(R, 3).astype(np.float32),
               kind=rs.randint(-1, 2, R).astype(np.int32),
               material=np.zeros(R, np.int32), n=n,
               g=f(R) * 0.5, sigma_s=rs.rand(R, 3).astype(np.float32) + 0.1)
    vps["p"][:8] = 0.51  # beside the dense cube
    p = f(I, 3)
    p[:300] = 0.5 + rs.rand(300, 3).astype(np.float32) * 0.05
    wi = f(I, 3)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    ph = dict(p=p, wi=wi, beta=rs.rand(I, 3).astype(np.float32),
              kind=rs.randint(0, 2, I).astype(np.int32),
              depth=rs.randint(0, 3, I).astype(np.int32),
              valid=rs.rand(I) < 0.9)
    radii = (rs.rand(R) * 0.3 + 0.05).astype(np.float32)
    return vps, ph, radii


def splat_gather_matches(ref, kernel):
    """The port's _splat_gather against bre_tpu's (the render's jitted
    gather, ``ref["splat"]``) on _fixed_gather_inputs."""
    ts = ref["scenes"][2]
    I = (CFG["maxdepth"] + 2) * CFG["photonsperiteration"]
    vps, ph, radii = _fixed_gather_inputs(I)
    cfg_t = tv.VSPPMConfig(kernel=kernel, **CFG)
    jt = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    ph_j = jt(ph)
    # typed as the photon pass types it (a where of two Python ints), so
    # that the render's compiled gather serves
    ph_j["kind"] = jnp.where(ph_j["kind"] == jv.VP_MEDIUM, jv.VP_MEDIUM,
                             jv.VP_SURFACE)
    Phi_j, M_j, ovf_j = ref["splat"](jv.VisiblePoints(**jt(vps)), jnp.asarray(radii),
                              jv.PhotonInteractions(**ph_j))
    tt = lambda d: {k: torch.from_numpy(np.asarray(v)).to(  # noqa: E731
        torch.int64 if np.asarray(v).dtype == np.int32 else None)
        for k, v in d.items()}
    Phi_t, M_t, ovf_t = tv._splat_gather(
        tv.VisiblePoints(**tt(vps)), torch.from_numpy(radii),
        tv.PhotonInteractions(**tt(ph)), ts.materials, cfg_t)
    np.testing.assert_array_equal(to_np(M_t), np.asarray(M_j))
    assert int(ovf_t) == int(ovf_j) > 0
    assert int(np.asarray(M_j).sum()) > 50
    np.testing.assert_allclose(to_np(Phi_t), np.asarray(Phi_j), rtol=RTOL,
                               atol=ATOL)


def test_splat_gather_matches_jax(ref):
    """Mixed kinds, a cell over the cap, radii from 0.05 to 0.35: Phi,
    M and the overflow (the same jitted gather as the render's)."""
    splat_gather_matches(ref, "compat")


def test_sppm_is_vsppm_without_media(ref):
    _, _, ts, tc = ref["scenes"]
    cfg = tv.VSPPMConfig(kernel="compat", **CFG)
    a, sa = textra.render_sppm(ts, tc, W, W, cfg)
    b, sb = tv.render_vsppm(ts, tc, W, W,
                            dataclasses.replace(cfg, rendermedia=False))
    assert torch.equal(a, b) and sa == sb
    assert sa["vp_medium"] == 0 and sa["vp_surface"] > 0


def test_vsppm_config_and_callback(ref):
    fj = [(f.name, f.default) for f in dataclasses.fields(jv.VSPPMConfig)]
    ft = [(f.name, f.default) for f in dataclasses.fields(tv.VSPPMConfig)]
    assert ft == fj
    _, _, ts, tc = ref["scenes"]
    seen = []
    cfg = tv.VSPPMConfig(iterations=3, maxdepth=2, photonsperiteration=50,
                         radius=0.25, imagewritefrequency=2)
    img, _ = tv.render_vsppm(ts, tc, W, W, cfg,
                             write_callback=lambda i, im: seen.append((i, im)))
    assert [i for i, _ in seen] == [1, 2]
    assert torch.equal(seen[-1][1], img)
    with pytest.raises(ValueError, match="kernel"):
        tv.render_vsppm(ts, tc, W, W, tv.VSPPMConfig(kernel="bre"))
