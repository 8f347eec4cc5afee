"""bre_tpu_torch's CLI against bre_tpu's, without rendering:
``render_photonbeam`` is replaced in both packages by a stand-in that
records its arguments and returns a fixed image.

For every photon-beam .pbrt the port renders, with and without --quick,
both CLIs hand render_photonbeam the same config field for field, the same
scene (bit for bit) and the same camera (1e-6, as in
tests/test_torch_parser.py); with a crop window and a film scale both write
byte-identical .pfm, .exr and .png files; --cat and --toply print the same
text; the integrators the port lacks return 1 with a message naming their
ROADMAP item; a missing scene returns 1."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from bre_tpu import cli as jcli
from bre_tpu.integrators import photonbeam as jpb
from bre_tpu_torch import cli as tcli
from bre_tpu_torch.scene.scene import scene_from_jax
from test_torch_parser import assert_cameras_equal, assert_scenes_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTONBEAM_PBRT = ["examples/cornell_fog.pbrt", "examples/fog_cube.pbrt",
                   "examples/smoke_hetero.pbrt", "tests/data/fog_golden.pbrt",
                   "tests/data/smoke_golden.pbrt"]


def _fixed_image(h, w):
    return np.random.RandomState(h * 1000 + w).rand(h, w, 3).astype(np.float32)


@pytest.fixture
def captured(monkeypatch):
    """Both packages' render_photonbeam replaced by a recorder."""
    calls = {}

    def fake(name, to_tensor):
        def render(scene, camera, width, height, cfg, *a, **kw):
            calls[name] = (scene, camera, width, height, cfg)
            img = _fixed_image(height, width)
            return (torch.from_numpy(img) if to_tensor else img), {"n": 1}
        return render

    monkeypatch.setattr(jpb, "render_photonbeam", fake("ref", False))
    monkeypatch.setattr(tcli, "render_photonbeam", fake("port", True))
    return calls


def _run_both(args, tmp_path, ext="pfm"):
    out_t, out_j = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    assert tcli.main(args + ["-o", str(out_t), "--device", "cpu"]) == 0
    assert jcli.main(args + ["-o", str(out_j)]) == 0
    return out_t.read_bytes(), out_j.read_bytes()


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("path", PHOTONBEAM_PBRT)
def test_cli_hands_render_the_same_inputs(path, quick, captured, tmp_path):
    args = [os.path.join(ROOT, path), "--quiet"] + (["--quick"] if quick else [])
    t_bytes, j_bytes = _run_both(args, tmp_path)
    assert t_bytes == j_bytes
    scene, cam, w, h, cfg = captured["port"]
    jscene, jcam, jw, jh, jcfg = captured["ref"]
    assert (w, h) == (jw, jh)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_scenes_equal(scene, scene_from_jax(jscene, device="cpu"))
    assert_cameras_equal(cam, jcam)


FILM = """Integrator "photonbeam" "integer iterations" [ 2 ]
Film "image" "integer xresolution" [ 20 ] "integer yresolution" [ 12 ]
    "string filename" "cropped.pfm" "float cropwindow" [ 0.15 0.8 0.2 0.95 ]
    "float scale" 1.7
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" 45
WorldBegin
LightSource "point" "rgb I" [ 1 1 1 ]
Shape "trianglemesh" "integer indices" [ 0 1 2 ] "point P" [ 0 0 1  1 0 1  0 1 1 ]
WorldEnd
"""


@pytest.mark.parametrize("ext", ["pfm", "exr", "png"])
def test_cli_film_crop_and_scale_bytes(ext, captured, tmp_path):
    scene = tmp_path / "film.pbrt"
    scene.write_text(FILM)
    t_bytes, j_bytes = _run_both([str(scene), "--quiet"], tmp_path, ext)
    assert t_bytes == j_bytes
    img = _fixed_image(12, 20)[3:12, 3:16] * np.float32(1.7)
    if ext == "pfm":
        assert t_bytes.endswith(np.flipud(img).astype("<f4").tobytes())


def test_cli_writes_film_filename(captured, tmp_path, monkeypatch):
    (tmp_path / "film.pbrt").write_text(FILM)
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["film.pbrt", "--device", "cpu"]) == 0
    assert (tmp_path / "cropped.pfm").exists()


@pytest.mark.parametrize("flag", ["--cat", "--toply"])
@pytest.mark.parametrize("path", ["examples/cornell_fog.pbrt",
                                  "tests/data/bdpt_golden.pbrt"])
def test_cli_cat_and_toply(path, flag, capsys):
    full = os.path.join(ROOT, path)
    assert tcli.main([full, flag]) == 0
    mine = capsys.readouterr().out
    assert jcli.main([full, flag]) == 0
    assert mine == capsys.readouterr().out and "WorldBegin" in mine


UNPORTED = {"vsppm": "tests/data/vsppm_golden.pbrt",
            "bdpt": "tests/data/bdpt_golden.pbrt",
            "volpath": None, "path": None, "whitted": None,
            "directlighting": None, "mlt": None}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_cli_unported_integrators_return_1(name, tmp_path, capsys):
    path = UNPORTED[name]
    if path is None:
        path = tmp_path / "s.pbrt"
        path.write_text(FILM.replace('"photonbeam"', f'"{name}"'))
    else:
        path = os.path.join(ROOT, path)
    assert tcli.main([str(path), "--device", "cpu", "-o",
                      str(tmp_path / "x.pfm")]) == 1
    err = capsys.readouterr().err
    assert (f"error: integrator '{name}' is not ported (ROADMAP Queue 1 "
            "item 4)") in err
    assert not (tmp_path / "x.pfm").exists()


def test_cli_missing_scene_returns_1(tmp_path, capsys):
    missing = str(tmp_path / "nowhere.pbrt")
    assert tcli.main([missing, "--device", "cpu"]) == 1
    assert tcli.main([missing, "--cat"]) == 1
    assert capsys.readouterr().err.count("scene file not found") == 2


def test_cli_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tcli.main([os.path.join(ROOT, "examples", "fog_cube.pbrt"), "--quick",
                   "-o", str(tmp_path / "f.pfm")])
    assert not (tmp_path / "f.pfm").exists()
