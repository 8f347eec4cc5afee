"""bre_tpu_torch.tools against bre_tpu.tools on the CPU: the Hosek-Wilkie
and Preetham skies, every imgtool subcommand (files, printed text, exit
codes), obj2pbrt and cyhair2pbrt byte for byte and through the port's
parser, and bsdftest's estimates; the array entry points default to the
card and raise without one."""

import contextlib
import io
import os
import re
import struct
import sys

import numpy as np
import pytest
import torch

from bre_tpu.io import image as JIMG
from bre_tpu.scene import parser as JPARSER
from bre_tpu.tools import bsdftest as JBT
from bre_tpu.tools import cyhair2pbrt as JHAIR
from bre_tpu.tools import hosek as JH
from bre_tpu.tools import imgtool as JIT
from bre_tpu.tools import obj2pbrt as JOBJ
from bre_tpu.tools import sky as JSKY
from bre_tpu_torch.io import image as TIMG
from bre_tpu_torch.scene import parser as TPARSER
from bre_tpu_torch.tools import bsdftest as TBT
from bre_tpu_torch.tools import cyhair2pbrt as THAIR
from bre_tpu_torch.tools import hosek as TH
from bre_tpu_torch.tools import imgtool as TIT
from bre_tpu_torch.tools import obj2pbrt as TOBJ
from bre_tpu_torch.tools import sky as TSKY

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_hosek import DIRS, STATES  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_hosek_data_is_the_reference_file():
    names = [os.path.join(ROOT, pkg, "tools", "data", "hosek_spectral.npz")
             for pkg in ("bre_tpu", "bre_tpu_torch")]
    with open(names[0], "rb") as a, open(names[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("si", range(len(STATES)))
def test_hosek_radiance(si):
    """Sky and solar radiance at test_hosek.py's directions (scalars) and
    on a batch of directions, within rtol 1e-12 of the reference's."""
    ref = JH.HosekSky(*STATES[si])
    port = TH.HosekSky(*STATES[si], device="cpu")
    np.testing.assert_array_equal(port.configs, ref.configs)
    np.testing.assert_array_equal(port.radiances, ref.radiances)
    for theta, gamma, wl in DIRS:
        for fn in ("radiance", "solar_radiance"):
            want = float(getattr(ref, fn)(theta, gamma, wl))
            got = float(getattr(port, fn)(theta, gamma, wl))
            assert got == pytest.approx(want, rel=1e-12), (fn, theta, wl)
    thetas = np.linspace(0.0, 1.5, 33)
    gammas = np.linspace(3.0, 0.0, 33)
    for wl in (300.0, 760.0):  # outside the bands: zero sky radiance
        assert not port.radiance(torch.from_numpy(thetas), 0.5, wl).any()
        assert not ref.radiance(thetas, 0.5, wl).any()
    for wl in (320.0, 455.0, 560.0, 715.0, 720.0):
        want = ref.solar_radiance(thetas, gammas, wl)
        got = port.solar_radiance(torch.from_numpy(thetas),
                                  torch.from_numpy(gammas), wl)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("model", ["hosek", "preetham"])
@pytest.mark.parametrize("layout", ["equalarea", "equirect"])
def test_make_sky_image(layout, model):
    for elevation in (30.0, 8.0):
        want = JSKY.make_sky_image(32, elevation, 3.0, layout, model=model)
        got = TSKY.make_sky_image(32, elevation, 3.0, layout, model=model,
                                  device="cpu")
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def test_hosek_sky_image_and_preetham():
    want = JH.hosek_sky_image(16, np.deg2rad(20.0), 4.0, 0.3)
    got = TH.hosek_sky_image(16, np.deg2rad(20.0), 4.0, 0.3, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    th = np.linspace(0.0, 2.0, 17)
    ph = np.linspace(-3.0, 3.0, 17)
    want = JSKY.preetham_sky(th, ph, 0.7, 0.2, 5.0)
    got = TSKY.preetham_sky(th, ph, 0.7, 0.2, 5.0, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# imgtool
# ---------------------------------------------------------------------------

def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


_NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?|[-+]?inf|nan")


def _same_text(got, want):
    """Equal apart from the last digits of printed floats (within 1e-5)."""
    assert _NUM.sub("#", got) == _NUM.sub("#", want)
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        if g != w:
            assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-9)


def _write_inputs(d):
    rs = np.random.RandomState(8)
    a = rs.rand(24, 32, 3).astype(np.float32)
    a[3, 4] = 12.0  # a firefly for bloom
    a[10, 20] = (7.0, 0.5, 6.0)
    b = a.copy()
    b[5:9, 6:9] += 0.25
    c = rs.rand(20, 20, 3).astype(np.float32)
    for name, img in (("a.pfm", a), ("b.pfm", b), ("c.pfm", c),
                      ("small.pfm", a[:3, :2])):
        JIMG.write_pfm(os.path.join(d, name), img)


IMGTOOL_CASES = {
    "diff_same": ["diff", "a.pfm", "a.pfm"],
    "diff_any": ["diff", "a.pfm", "b.pfm"],
    "diff_tol_pass": ["diff", "a.pfm", "b.pfm", "--tol", "0.1"],
    "diff_tol_fail": ["diff", "a.pfm", "b.pfm", "--tol", "1e-6", "-o",
                      "d.pfm"],
    "diff_size": ["diff", "a.pfm", "c.pfm"],
    "cat": ["cat", "small.pfm"],
    "convert_scale": ["convert", "a.pfm", "o.pfm", "--scale", "2.5"],
    "convert_bloom": ["convert", "a.pfm", "o.pfm", "--scale", "2",
                      "--bloomlevel", "5", "--bloomwidth", "2",
                      "--bloomiters", "2", "--bloomscale", "0.4",
                      "--tonemap", "--maxluminance", "3"],
    "convert_repeat": ["convert", "a.pfm", "o.pfm", "--repeatpix", "3",
                       "--flipy"],
    "assemble": ["assemble", "o.pfm", "a.pfm", "b.pfm", "a.pfm"],
    "assemble_size": ["assemble", "o.pfm", "a.pfm", "c.pfm"],
    "makesky": ["makesky", "-o", "o.pfm", "--resolution", "32",
                "--elevation", "25", "--layout", "equirect"],
    "makesky_preetham": ["makesky", "-o", "o.pfm", "--resolution", "24",
                         "--model", "preetham", "--turbidity", "5"],
}


@pytest.mark.parametrize("case", sorted(IMGTOOL_CASES))
def test_imgtool(case, tmp_path, monkeypatch):
    """The same exit code, printed text and output file as the reference's
    imgtool, run on the same seeded images."""
    results = {}
    for pkg, main in (("ref", JIT.main), ("port", TIT.main)):
        d = tmp_path / pkg
        d.mkdir()
        _write_inputs(str(d))
        monkeypatch.chdir(d)
        argv = list(IMGTOOL_CASES[case])
        if pkg == "port" and argv[0] != "cat":
            argv += ["--device", "cpu"]
        results[pkg] = _run(main, argv)
        outs = [f for f in ("o.pfm", "d.pfm") if (d / f).exists()]
        results[pkg] += ({f: TIMG.read_pfm(str(d / f)) for f in outs},)
    (rc_r, out_r, err_r, files_r), (rc_p, out_p, err_p, files_p) = (
        results["ref"], results["port"])
    assert rc_p == rc_r
    _same_text(out_p, out_r)
    assert err_p == err_r
    assert files_p.keys() == files_r.keys()
    for name, want in files_r.items():
        np.testing.assert_allclose(files_p[name], want, rtol=1e-6,
                                   atol=1e-7 * np.abs(want).max())
    expect_rc = {"diff_any": 1, "diff_tol_fail": 1, "diff_size": 1,
                 "assemble_size": 1}
    assert rc_p == expect_rc.get(case, 0)


def test_imgtool_bloom_wider_than_image(tmp_path):
    """The reference's bloom is np.convolve(mode="same"), which returns
    2w+1 values on an axis shorter than that: on an 8x8 image with the
    default bloomwidth of 15 it raises.  The port keeps the image's size:
    a zero-padded box blur (ROADMAP Queue 3)."""
    img = np.zeros((8, 8, 3), np.float32)
    img[2, 3] = 10.0
    src, out = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    JIMG.write_pfm(src, img)
    argv = ["convert", src, out, "--bloomlevel", "5", "--bloomiters", "1"]
    with pytest.raises(ValueError):
        _run(JIT.main, argv)
    assert _run(TIT.main, argv + ["--device", "cpu"])[0] == 0
    k = np.float32(1.0) / np.float32(31)
    # every pixel is within the firefly's reach on both axes
    want = img + np.float32(0.3) * (np.float32(10.0) * k * k)
    np.testing.assert_allclose(TIMG.read_pfm(out), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# obj2pbrt, cyhair2pbrt
# ---------------------------------------------------------------------------

OBJ = """\
# a quad, a fan of five, a lamp; relative (negative) indices
mtllib scene.mtl
o panel
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 -1
vt 0 0
vt 2 0
vt 2 3
vt 0 3
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
g pentagon
v 2 0 0.5
v 2.8 0.3 0.5
v 2.9 1.0 0.5
v 2.4 1.4 0.5
v 1.9 0.9 0.5
usemtl tex
f -5/-4 -4/-3 -3/-2 -2/-1 -1/-4
g lamp
usemtl glow
f 1//1 3//1 4//1
g bare
usemtl nothing
f 5 6 7
"""

MTL = """\
newmtl red
Kd 0.8 0.1 0.1
Ks 0.2 0.2 0.2
Ns 50
Ni 1.4
newmtl tex
Kd 0.5 0.5 0.5
map_Kd tex.pfm
d 0.9
newmtl glow
Kd 0 0 0
Ke 5 4 3
"""

SCENE_HEAD = ('Film "image" "integer xresolution" 8 "integer yresolution" 8\n'
              "LookAt 1 0.5 -3 1 0.5 0 0 1 0\n"
              'Camera "perspective"\nWorldBegin\n')


def _same_triangles(port_scene, ref_scene):
    assert port_scene.n_triangles == ref_scene.n_triangles
    assert port_scene.n_lights == ref_scene.n_lights
    for k in ("p0", "p1", "p2"):
        np.testing.assert_array_equal(
            getattr(port_scene.triangles, k).numpy(),
            np.asarray(getattr(ref_scene.triangles, k)))


def _obj2pbrt_both(tmp_path, mtl):
    """Both converters on OBJ with ``mtl``: the same text byte for byte, the
    same exit code and message; returns the text."""
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "scene.mtl").write_text(mtl)
    obj = str(tmp_path / "scene.obj")
    rc_r, _, err_r = _run(JOBJ.main, [obj, str(tmp_path / "ref.pbrt")])
    rc_p, _, err_p = _run(TOBJ.main, [obj, str(tmp_path / "port.pbrt")])
    assert rc_p == rc_r == 0
    assert err_p.replace("port.pbrt", "") == err_r.replace("ref.pbrt", "")
    text = (tmp_path / "port.pbrt").read_bytes()
    assert text == (tmp_path / "ref.pbrt").read_bytes()
    return text


def test_obj2pbrt_bytes_and_scene(tmp_path):
    """Quads and a five-gon (fan triangulated), negative indices, vt, vn, an
    MTL with a texture map and an emitter, and a face with an unknown
    material: the same .pbrt text byte for byte.  Without the texture map
    (the reference's parser reads no "texture Kd" in MakeNamedMaterial),
    the port's parser builds the reference's triangles from it."""
    text = _obj2pbrt_both(tmp_path, MTL)
    assert b'"float st"' in text and b'"normal N"' in text
    assert b"AreaLightSource" in text and b"imagemap" in text
    text = _obj2pbrt_both(tmp_path, MTL.replace("map_Kd tex.pfm\n", ""))
    assert b"imagemap" not in text
    scene = tmp_path / "world.pbrt"
    scene.write_text(SCENE_HEAD + text.decode() + "WorldEnd\n")
    ref = JPARSER.parse_file(str(scene)).build()
    port = TPARSER.parse_file(str(scene), device="cpu").build(device="cpu")
    _same_triangles(port, ref)
    assert port.n_triangles == 2 + 3 + 1 + 1 and port.n_lights == 1


def _write_cyhair(path, n_strands=5, seed=10):
    """A cyHair file with per-strand segment counts (one strand of a single
    point, which the converter skips) and per-point thickness."""
    rs = np.random.RandomState(seed)
    segments = np.array([3, 0, 5, 1, 7][:n_strands], "<u2")
    n_points = int((segments + 1).sum())
    pts = np.cumsum(rs.uniform(-0.1, 0.1, (n_points, 3)), 0).astype("<f4")
    thick = rs.uniform(0.005, 0.03, n_points).astype("<f4")
    with open(path, "wb") as f:
        f.write(b"HAIR")
        f.write(struct.pack("<III", n_strands, n_points, 1 | 2 | 4))
        f.write(struct.pack("<I", 0))
        f.write(struct.pack("<f", 0.01))
        f.write(struct.pack("<f", 0.0))
        f.write(struct.pack("<fff", 0, 0, 0))
        f.write(b"\0" * 88)
        f.write(segments.tobytes())
        f.write(pts.tobytes())
        f.write(thick.tobytes())
    return n_points


def test_cyhair2pbrt_bytes_and_scene(tmp_path):
    """The same curve statements byte for byte, the same printed count and
    exit code; the port's parser tessellates them into the reference's
    triangles (the curves' control points carried through)."""
    hair = str(tmp_path / "t.hair")
    _write_cyhair(hair)
    strands_r, _ = JHAIR.read_cyhair(hair)
    strands_p, _ = THAIR.read_cyhair(hair)
    for a, b in zip(strands_p, strands_r):
        np.testing.assert_array_equal(a, b)
    rc_r, out_r, _ = _run(JHAIR.main, [hair, str(tmp_path / "ref.pbrt")])
    rc_p, out_p, _ = _run(THAIR.main, [hair, str(tmp_path / "port.pbrt")])
    assert rc_p == rc_r == 0 and out_p == out_r == "cyhair2pbrt: wrote 4 strands\n"
    text = (tmp_path / "port.pbrt").read_bytes()
    assert text == (tmp_path / "ref.pbrt").read_bytes()
    assert text.count(b'Shape "curve"') == 3 + 5 + 1 + 7
    assert _run(THAIR.main, [hair])[0] == 1  # usage
    scene = tmp_path / "world.pbrt"
    scene.write_text(SCENE_HEAD + 'Material "matte"\n' + text.decode()
                     + "WorldEnd\n")
    ref = JPARSER.parse_file(str(scene)).build()
    port = TPARSER.parse_file(str(scene), device="cpu").build(device="cpu")
    _same_triangles(port, ref)


# ---------------------------------------------------------------------------
# bsdftest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["matte", "plastic"])
def test_bsdftest_material(name):
    """The two streams of the reference (PCG32 and RandomState(seed)): the
    four figures within 1e-5 relative."""
    want = JBT.test_material(name, 8192)
    got = TBT.test_material(name, 8192, device="cpu")
    assert got["specular"] == want["specular"]
    for k in ("rho_is", "rho_uni", "pdf_integral"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_bsdftest_main():
    """main on the reference test's arguments: exit code 0 and the same
    table; test_material is a tool, which pytest does not collect."""
    argv = ["--materials", "matte", "plastic", "--n", "8192"]
    rc_r, out_r, _ = _run(JBT.main, argv)
    rc_p, out_p, _ = _run(TBT.main, argv + ["--device", "cpu"])
    assert rc_p == rc_r == 0
    _same_text(out_p, out_r)
    assert TBT.test_material.__test__ is False


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------

def _film():
    from bre_tpu_torch.film import make_film

    return make_film(4, 4)


def _trace(tmp_path):
    from bre_tpu_torch.utils.stats import trace_to

    with trace_to(str(tmp_path / "t")):
        pass


ENTRY_POINTS = {
    "make_film": lambda tmp: _film(),
    "make_sky_image": lambda tmp: TSKY.make_sky_image(8),
    "hosek_sky_image": lambda tmp: TH.hosek_sky_image(4, 0.3),
    "HosekSky": lambda tmp: TH.HosekSky(0.3, 3.0, 0.5),
    "test_material": lambda tmp: TBT.test_material("matte", 16),
    "trace_to": _trace,
    "imgtool": lambda tmp: TIT.main(["makesky", "-o", str(tmp / "s.pfm"),
                                     "--resolution", "8"]),
    "bsdftest": lambda tmp: TBT.main(["--n", "16"]),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_need_a_card(entry, tmp_path):
    """Without device="cpu" (or --device cpu) each array entry point asks
    for the card and raises without one; none carries on on the CPU."""
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        with contextlib.redirect_stdout(io.StringIO()):
            ENTRY_POINTS[entry](tmp_path)
