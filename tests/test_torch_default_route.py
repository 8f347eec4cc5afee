"""bre_tpu_torch's default route vs bre_tpu: every reference
PhotonBeamConfig in the repo constructs in the port field for field;
the port's parser builds the scene and camera of examples/cornell_fog.pbrt
(which chip_smoke.py renders as the CLI's config 2) that bre_tpu's parser
builds, and ``cli.photonbeam_config`` takes its settings from the file;
``render_photonbeam`` at the default config (gather="auto", grad_geometry=True).  The other options of
the route: tests/test_torch_default_route_breadth.py; the graft entry
point, the finite-difference gate and the train step:
tests/test_torch_graft_entry.py, test_torch_fd_gate.py and
test_torch_train_step.py (one file each: each compiles a JAX graph of tens
of seconds).

Tolerances and their reasons: configs and scenes compare exactly, the
camera matrices to 1e-6 (the parser inverts the LookAt twice in float64).
Renders share bit-identical PCG32 streams and differ only where a
float-ulp difference flips a photon or camera-path decision: image means
within 0.5%, 99% of pixels within rtol 1e-3 (tests/test_torch_render.py:
32-49).  Gradients of the attached estimator through the recompute
backward: each cotangent against its own max|ref| at 2e-4
(tests/test_pallas_gather.py:97)."""

import ast
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from bre_tpu.core import transform as jtfm
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu.scene.builder import SceneBuilder as JBuilder
from bre_tpu.scene.camera import make_perspective_camera as jcam
from bre_tpu.scene.parser import parse_file
from bre_tpu_torch import cli as tcli
from bre_tpu_torch.core import transform as ttfm
from bre_tpu_torch.integrators import photonbeam as tpb
from bre_tpu_torch.scene.builder import SceneBuilder as TBuilder
from bre_tpu_torch.scene.camera import make_perspective_camera as tcam
from bre_tpu_torch.scene.parser import parse_file as tparse_file
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import cornell_fog, leaves, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 2e-4
CPU = torch.device("cpu")


def _sources():
    files = sorted(glob.glob(os.path.join(ROOT, "examples", "*.py")))
    files += [os.path.join(ROOT, p) for p in
              ("bench.py", "__graft_entry__.py", "bre_tpu/cli.py")]
    return [os.path.relpath(f, ROOT) for f in files
            if "PhotonBeamConfig(" in open(f).read()]


def _config_calls(path):
    """Keyword arguments of every PhotonBeamConfig(...) call in ``path``:
    literals as written; a name or an expression (a command-line argument,
    a local) takes the reference's default for that field, as the keyword
    itself is what must construct."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    defaults = jpb.PhotonBeamConfig()
    calls = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "PhotonBeamConfig"):
            kw = {}
            for k in node.keywords:
                try:
                    kw[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    kw[k.arg] = getattr(defaults, k.arg)
            calls.append(kw)
    return calls


@pytest.mark.parametrize("path", _sources())
def test_reference_configs_construct(path):
    calls = _config_calls(path)
    assert calls, path
    for kw in calls + [{}]:
        j, t = jpb.PhotonBeamConfig(**kw), tpb.PhotonBeamConfig(**kw)
        assert ([f.name for f in dataclasses.fields(t)]
                == [f.name for f in dataclasses.fields(j)])
        assert dataclasses.asdict(t) == dataclasses.asdict(j), kw


def test_cornell_fog_pbrt_scene_matches_parser():
    path = os.path.join(ROOT, "examples", "cornell_fog.pbrt")
    ps = parse_file(path)
    ref = scene_from_jax(ps.build(), device="cpu")
    mine_ps = tparse_file(path, device="cpu")
    mine = mine_ps.build(device="cpu")
    for part in ("spheres", "triangles", "materials", "media", "lights"):
        for (name, x), (_, y) in zip(leaves(getattr(mine, part)),
                                     leaves(getattr(ref, part))):
            if not isinstance(x, torch.Tensor):  # FourierTables.m_max
                assert x == y, (part, name)
                continue
            assert x.dtype == y.dtype and x.shape == y.shape, (part, name)
            assert torch.equal(x, y), (part, name)
    for name in ("camera_medium", "world_min", "world_max"):
        assert torch.equal(getattr(mine, name), getattr(ref, name)), name
    cam = mine_ps.camera
    for name in ("camera_to_world", "raster_to_camera"):
        np.testing.assert_allclose(to_np(getattr(cam, name)),
                                   to_np(getattr(ps.camera, name)), atol=1e-6)
    p = {k: (v[0] if isinstance(v, list) else v)
         for k, v in ps.integrator_params.items()}
    assert mine_ps.integrator_params == ps.integrator_params
    assert (mine_ps.width, mine_ps.height) == (ps.width, ps.height) == (256,) * 2
    cfg = tcli.photonbeam_config(mine_ps)
    assert (cfg.iterations, cfg.photonsperiteration, cfg.maxdepth) == (
        p["iterations"], p["photonsperiteration"], p["maxdepth"])
    assert np.float32(cfg.initialbeamradius) == np.float32(
        p["initialbeamradius"])

W = 16
LOOK = ((0, 0, -2.2), (0, 0, 1), (0, 1, 0))
CFG = dict(iterations=2, maxdepth=5, photonsperiteration=4000,
           initialbeamradius=0.12, alpha=0.7)


def _images_agree(it, ij):
    it, ij = to_np(it), to_np(ij)
    assert it.shape == ij.shape and np.isfinite(it).all() and ij.mean() > 0
    assert abs(it.mean() / ij.mean() - 1.0) < 5e-3
    close = np.isclose(it, ij, rtol=1e-3, atol=1e-6).all(-1)
    assert close.mean() >= 0.99, close.mean()


def render_both(over):
    """The Cornell fog scene at 16x16, 4,000 photons, 2 iterations through
    both packages' render_photonbeam with ``CFG`` and ``over``; the port
    must never call the packed route."""
    ij, _ = jpb.render_photonbeam(
        cornell_fog(JBuilder()), jcam(jtfm.look_at(*LOOK), 50.0, W, W), W, W,
        jpb.PhotonBeamConfig(**CFG, **over))
    n0 = tpb.gather_beams_packed.calls
    it, _ = tpb.render_photonbeam(
        cornell_fog(TBuilder(), device="cpu"),
        tcam(ttfm.look_at(*LOOK), 50.0, W, W, device="cpu"), W, W,
        tpb.PhotonBeamConfig(**CFG, **over))
    assert tpb.gather_beams_packed.calls == n0  # never the packed route
    return it, ij


def test_render_default_config_matches():
    """PhotonBeamConfig's defaults: gather="auto", grad_geometry=True,
    gather_chunk=2048 (the non-packed route, the forward kernel's plain
    version)."""
    _images_agree(*render_both({}))


def _graft_scene(builder, wh, **build_kw):
    """__graft_entry__._fog_scene on either package's builder."""
    fog = builder.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.0)
    wall = builder.matte((0.6, 0.6, 0.6))
    builder.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
                medium_outside=-1)
    builder.quad((-3, -3, 3.0), (-3, 3, 3.0), (3, 3, 3.0), (3, -3, 3.0),
                 material=wall)
    builder.point_light((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), medium=fog)
    return builder.build(**build_kw)


GRAFT_LOOK = ((0, 0, -3.5), (0, 0, 0), (0, 1, 0))
