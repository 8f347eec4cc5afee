"""bre_tpu_torch's .pbrt parser against bre_tpu's.

The lexer equals the reference's ``tokenize`` on every .pbrt in the repo;
``parse_params`` types values as the reference does; and on every .pbrt
file and on synthetic strings for each construct (every material and
texture class among them), ``parse_*(...).build(device="cpu")`` equals
``scene_from_jax(reference.build())``.  Nothing the reference builds
raises: the statements of the old raise list (hair, subsurface,
kdsubsurface, fourier, a mix of mixes, the orthographic, realistic and
environment cameras) build as the reference's, as does every new Material
and Camera statement with its parameters (a ``.bsdf`` file and a lens file
written beside the scene); the distant, infinite, spot, goniometric and
projection LightSource statements and every Shape statement build as the
reference's.

Tolerances: scene tensors compare with ``torch.equal`` (dtype, shape and
bits: the CTM and every transformed point are computed with the
reference's numpy float32 expressions); the camera matrices to 1e-6 (the
reference's camera is a JAX array made from the same float32 matrices); the
film, integrator and sampler fields exactly."""

import glob
import os
import warnings

import numpy as np
import pytest
import torch

from bre_tpu.scene import parser as jparser
from bre_tpu_torch.io.image import write_pfm
from bre_tpu_torch.io.ply import write_ply
from bre_tpu_torch.scene import parser as tparser
from bre_tpu_torch.scene.scene import scene_from_jax
from torch_parity import to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_PBRT = sorted(os.path.relpath(p, ROOT) for p in
                  glob.glob(os.path.join(ROOT, "examples", "*.pbrt"))
                  + glob.glob(os.path.join(ROOT, "tests", "data", "*.pbrt")))
GLASS_PBRT = ["examples/glass_caustics.pbrt", "tests/data/caustics_golden.pbrt",
              "tests/data/caustics_golden8.pbrt"]
IN_SLICE_PBRT = [p for p in ALL_PBRT if p not in GLASS_PBRT]


def assert_scenes_equal(mine, ref, name=()):
    """Every tensor of two port Scenes, nested tables included: dtype,
    shape and bits."""
    if mine is None:  # tri_bvh below builder.BVH_MIN_TRIANGLES
        assert ref is None, name
    elif isinstance(mine, torch.Tensor):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape, (
            name, mine, ref)
        assert torch.equal(mine, ref), name
    elif hasattr(mine, "_fields"):
        for part in mine._fields:
            assert_scenes_equal(getattr(mine, part), getattr(ref, part),
                                name + (part,))
    else:  # Textures.depth, FourierTables.m_max: ints
        assert mine == ref, name


def assert_cameras_equal(cam, cam_ref):
    """The matrices to 1e-6; the kind, the lens and the lens stack (host
    values) bit for bit the reference's float32 values."""
    for name in ("camera_to_world", "raster_to_camera"):
        np.testing.assert_allclose(to_np(getattr(cam, name)),
                                   to_np(getattr(cam_ref, name)), atol=1e-6)
    assert cam.ctype == int(np.asarray(cam_ref.ctype))
    for name in ("lens_radius", "focal_distance", "rear_radius", "rear_z",
                 "lens_curv", "lens_thick", "lens_eta", "lens_aperture"):
        want = np.asarray(getattr(cam_ref, name), np.float32).reshape(-1)
        got = np.asarray(getattr(cam, name), np.float32).reshape(-1)
        assert np.array_equal(got, want), name


def assert_parsed_equal(ps, ps_ref):
    """A port ParsedScene against a reference one: the built scene, the
    camera and the film/integrator/sampler fields."""
    assert_scenes_equal(ps.build(device="cpu"),
                        scene_from_jax(ps_ref.build(), device="cpu"))
    assert (ps.camera is None) == (ps_ref.camera is None)
    if ps.camera is not None:
        assert_cameras_equal(ps.camera, ps_ref.camera)
    for name in ("width", "height", "filename", "integrator_name",
                 "integrator_params", "sampler_name", "sampler_params",
                 "filter_name", "crop", "film_scale",
                 "max_sample_luminance"):
        assert getattr(ps, name) == getattr(ps_ref, name), name


@pytest.mark.parametrize("path", ALL_PBRT)
def test_tokenize_native_plain_reference(path):
    text = open(os.path.join(ROOT, path)).read()
    toks = tparser.tokenize(text)
    assert toks == jparser.tokenize(text)
    assert len(toks) > 50


def test_parse_params_typed_as_reference():
    text = ('"integer n" [ 3 ] "integer list" [ 1 2 4 ] "float f" 0.5 '
            '"float fs" [ 1 2 ] "rgb c" [ .1 .2 .3 ] "point p" [ 1 2 3 ] '
            '"normal N" [ 0 0 1 ] "bool on" "true" "bool off" [ "false" ] '
            '"string s" "name" "string ss" [ "a" "b" ] "texture Kd" "tex" '
            '"spectrum sp" [ 400 1 700 2 ] "blackbody bb" [ 6500 1 ] '
            'Shape')
    ts = tparser._TokenStream(tparser.tokenize(text), ".")
    js = jparser._TokenStream(jparser.tokenize(text), ".")
    mine, ref = tparser.parse_params(ts), jparser.parse_params(js)
    assert mine == ref and ts.pos == js.pos and ts.peek() == "Shape"

    def types(d):
        return {k: [type(x) for x in v] if isinstance(v, list) else type(v)
                for k, v in d.items()}

    assert types(mine) == types(ref)


@pytest.mark.parametrize("path", IN_SLICE_PBRT)
def test_parse_file_matches_reference(path):
    full = os.path.join(ROOT, path)
    assert_parsed_equal(tparser.parse_file(full, device="cpu"),
                        jparser.parse_file(full))


HEAD = """Film "image" "integer xresolution" [ 24 ] "integer yresolution" [ 16 ]
    "string filename" "x.exr" "float scale" 2 "float cropwindow" [ 0.1 0.9 0 1 ]
    "float maxsampleluminance" 10
Sampler "halton" "integer pixelsamples" 4
PixelFilter "gaussian" "float xwidth" 2
Accelerator "bvh"
LookAt 0.5 1 -4   0 0.2 0   0 1 0
Camera "perspective" "float fov" 50 "float lensradius" 0.1
    "float focaldistance" 3
"""
MESH = ('Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ] '
        '"point P" [ -1 -1 0  1 -1 0  1 1 0  -1 1 0 ]\n')

SYNTHETIC = {
    "transforms": HEAD + """WorldBegin
Material "matte" "rgb Kd" [ .5 .4 .3 ]
TransformBegin
  Translate 0.5 -0.25 1
  Rotate 30 1 2 3
  Scale 0.5 1.5 2
""" + MESH + """TransformEnd
TransformBegin
  Transform [ 1 0 0 0  0 0 1 0  0 -1 0 0  0.5 0.25 2 1 ]
  ConcatTransform [ 0.8 0.1 0 0  -0.1 0.9 0 0  0 0 1.2 0  0 1 0 1 ]
""" + MESH + """  CoordinateSystem "here"
  Identity
  Scale 3 3 3
  CoordSysTransform "here"
  Rotate -45 0 1 0
""" + MESH + """TransformEnd
TransformBegin
  CoordSysTransform "camera"
  Translate 0 0 5
""" + MESH + """TransformEnd
TransformTimes 0 1
ActiveTransform StartTime
ActiveTransform All
LightSource "point" "point from" [ 0 2 0 ] "rgb I" [ 3 3 3 ]
    "rgb scale" [ 2 1 .5 ]
WorldEnd
""",
    "nested attributes": HEAD + """WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [ .05 .05 .05 ] "rgb sigma_s" [ .5 .5 .5 ] "float g" 0.3
    "float scale" 2
AttributeBegin
  Material "matte" "rgb Kd" [ .7 .1 .1 ] "float sigma" 10
  MediumInterface "fog" ""
  Translate 0 1 0
  AttributeBegin
    Material "none"
    Rotate 90 0 0 1
""" + MESH + """    AttributeBegin
      AreaLightSource "diffuse" "rgb L" [ 4 3 2 ] "bool twosided" "true"
      Translate 0 0 1
""" + MESH + """      Material "matte" "rgb Kd" [ .2 .2 .2 ]
""" + MESH + """    AttributeEnd
""" + MESH + """  AttributeEnd
""" + MESH + """  ObjectBegin "thing"
    Scale 2 2 2
""" + MESH + """  ObjectEnd
  ObjectInstance "thing"
AttributeEnd
""" + MESH + """AttributeBegin
  MediumInterface "" "fog"
  LightSource "point" "rgb I" [ 1 1 1 ]
AttributeEnd
AttributeEnd
WorldEnd
""",
    "reverse orientation, N and uv": HEAD + """WorldBegin
AttributeBegin
  Rotate 20 0 1 1
  Scale 1 2 0.5
  ReverseOrientation
  Material "matte"
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -1 -1 0  1 -1 0.2  1 1 0  -1 1 -0.1 ]
      "normal N" [ 0 0 1  0.1 0 1  0 0.2 1  0 0 -1 ]
      "float uv" [ 0 0  1 0  1 1  0 1 ]
  ReverseOrientation
  Shape "trianglemesh" "integer indices" [ 0 1 2 ]
      "point P" [ 0 0 1  1 0 1  0 1 1 ] "float st" [ 0 0  0.5 0.2  0 1 ]
  ReverseOrientation
  Shape "trianglemesh" "integer indices" [ 0 1 2 ]
      "point P" [ 0 0 2  1 0 2  0 1 2 ] "float uv" [ 0 0  0 0  0 0 ]
AttributeEnd
LightSource "point" "rgb I" [ 1 1 1 ]
WorldEnd
""",
    "heightfield and plymesh": HEAD + """WorldBegin
Material "matte" "rgb Kd" [ .3 .6 .3 ]
AttributeBegin
  Translate -1 -1 0
  Scale 2 2 0.5
  Shape "heightfield" "integer nu" 4 "integer nv" 3
      "float Pz" [ 0 .1 .2 .1  .3 .5 .4 .2  0 .2 .1 0 ]
AttributeEnd
AttributeBegin
  Translate 0 0 2
  Rotate 15 0 0 1
  Shape "plymesh" "string filename" "mesh.ply"
AttributeEnd
WorldEnd
""",
    "sphere": HEAD + """WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [ .05 .05 .05 ] "rgb sigma_s" [ .5 .5 .5 ]
AttributeBegin
  MediumInterface "" "fog"
  Translate 0 0 3
  Scale 1 1 1
  Material "matte" "rgb Kd" [ .6 .5 .4 ]
  Shape "sphere" "float radius" 0.7
  Translate 1 0 0
  MediumInterface "fog" ""
  Material "none"
  Shape "sphere"
AttributeEnd
""" + MESH + """WorldEnd
""",
    "area light sphere": HEAD + """WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [ .05 .05 .05 ] "rgb sigma_s" [ .5 .5 .5 ]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [ 1 1 1 ]
  Shape "sphere"
AttributeEnd
AttributeBegin
  MediumInterface "fog" "fog"
  Translate 0.5 1 2
  AreaLightSource "diffuse" "rgb L" [ 4 3 2 ] "bool twosided" "true"
  Material "matte" "rgb Kd" [ .2 .3 .4 ]
  Shape "sphere" "float radius" 0.25
AttributeEnd
""" + MESH + """WorldEnd
""",
    "named materials": HEAD + """WorldBegin
MakeNamedMaterial "red" "string type" "matte" "rgb Kd" [ .8 .1 .1 ]
MakeNamedMaterial "plain" "rgb Kd" [ .4 .4 .4 ]
MakeNamedMaterial "nothing" "string type" "none"
NamedMaterial "red"
""" + MESH + """NamedMaterial "plain"
""" + MESH + """NamedMaterial "nothing"
""" + MESH + """NamedMaterial "undefined"
""" + MESH + """WorldEnd
""",
    "medium preset": HEAD + """WorldBegin
MakeNamedMedium "milk" "string type" "homogeneous" "string preset" "Skimmilk"
    "float scale" 0.5 "float g" 0.1
MakeNamedMedium "coke" "string preset" "Coke"
AttributeBegin
  MediumInterface "milk" "coke"
  Material "none"
""" + MESH + """AttributeEnd
WorldEnd
""",
    "camera medium": """MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [ .02 .02 .02 ] "rgb sigma_s" [ .3 .3 .3 ]
MakeNamedMedium "haze" "string type" "homogeneous"
    "rgb sigma_s" [ .1 .1 .1 ]
MediumInterface "haze" "fog"
""" + HEAD + """WorldBegin
MediumInterface "" "fog"
""" + MESH + """WorldEnd
""",
    "grid medium": HEAD + """WorldBegin
AttributeBegin
  Rotate 30 0 1 0
  MakeNamedMedium "smoke" "string type" "heterogeneous"
      "integer nx" [ 3 ] "integer ny" [ 2 ] "integer nz" [ 2 ]
      "point p0" [ -1 -0.5 -1 ] "point p1" [ 1 1.5 0.5 ]
      "rgb sigma_a" [ .02 .02 .02 ] "rgb sigma_s" [ .6 .6 .6 ] "float g" 0.4
      "float density" [ 0.1 0.2 0.3 0.4 0.5 0.6 0.7 0.8 0.9 1.0 1.1 1.2 ]
AttributeEnd
MediumInterface "smoke" ""
""" + MESH + """WorldEnd
""",
}


def _write_mesh_ply(directory):
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0.5, 0.5, 1]], np.float32)
    write_ply(os.path.join(directory, "mesh.ply"), verts,
              np.array([[0, 1, 2], [0, 2, 3], [0, 1, 4]], np.int32))


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_parse_string_matches_reference(name, tmp_path):
    _write_mesh_ply(tmp_path)
    text = SYNTHETIC[name]
    assert_parsed_equal(
        tparser.parse_string(text, include_dir=tmp_path, device="cpu"),
        jparser.parse_string(text, include_dir=tmp_path))


def test_include_matches_reference(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "geom.pbrt").write_text(
        'Material "matte" "rgb Kd" [ .2 .3 .4 ]\n' + MESH
        + 'Include "more.pbrt"\n')
    (tmp_path / "sub" / "more.pbrt").write_text("Translate 0 0 1\n" + MESH)
    # nested Includes resolve against the top file's directory, as in the
    # reference
    (tmp_path / "more.pbrt").write_text("Translate 0 0 1\n" + MESH)
    text = HEAD + 'WorldBegin\nInclude "sub/geom.pbrt"\n' + MESH + "WorldEnd\n"
    assert_parsed_equal(
        tparser.parse_string(text, include_dir=tmp_path, device="cpu"),
        jparser.parse_string(text, include_dir=tmp_path))


FALLBACKS = {
    "unknown directive": ("MakeFog \"x\" \"float y\" 2\n", "unknown directive"),
    "unknown material": ('Material "velvet" "rgb Kd" [ .1 .2 .3 ]\n',
                         "not implemented; using matte"),
    "fourier without bsdffile": ('Material "fourier"\n', "needs bsdffile"),
    "mix without named materials": ('Material "mix"\n', "namedmaterial1/2"),
    "unknown light": ('LightSource "laser" "rgb I" [ 2 2 2 ]\n',
                      "treated as point"),
    "unknown shape": ('Shape "torus" "float radius" 2\n', "skipped"),
    "unknown medium type": ('MakeNamedMedium "m" "string type" "cloudy"\n',
                            "unsupported"),
    "unknown preset": ('MakeNamedMedium "m" "string preset" "Soup"\n',
                       "unknown"),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_warn_and_fall_back_as_reference(name):
    line, message = FALLBACKS[name]
    text = HEAD + "WorldBegin\n" + line + MESH + "WorldEnd\n"
    with pytest.warns(UserWarning, match=message):
        mine = tparser.parse_string(text, device="cpu")
    with pytest.warns(UserWarning, match=message):
        ref = jparser.parse_string(text)
    assert_parsed_equal(mine, ref)


def test_unknown_camera_falls_back_to_perspective():
    text = HEAD.replace('Camera "perspective"', 'Camera "fisheye"')
    with pytest.warns(UserWarning, match="using perspective"):
        mine = tparser.parse_string(text + "WorldBegin\n" + MESH + "WorldEnd\n",
                                    device="cpu")
    with pytest.warns(UserWarning, match="using perspective"):
        ref = jparser.parse_string(text + "WorldBegin\n" + MESH + "WorldEnd\n")
    assert_parsed_equal(mine, ref)


# the materials and textures the port builds since the surface-material
# slice: each case a scene held bit for bit against the reference's
SURFACE = {
    **{f"material {m}": f'Material "{m}"\n' for m in (
        "mirror", "glass", "metal", "plastic", "uber", "substrate",
        "translucent")},
    "material mix": ('MakeNamedMaterial "a" "string type" "matte"\n'
                     'MakeNamedMaterial "b" "string type" "matte"\n'
                     'Material "mix" "string namedmaterial1" "a" '
                     '"string namedmaterial2" "b"\n'),
    "matte Kd texture": ('Texture "checks" "spectrum" "checkerboard"\n'
                         'Material "matte" "texture Kd" "checks"\n'),
    "texture": 'Texture "checks" "spectrum" "checkerboard"\n',
    **{f"texture {c}": (f'Texture "t" "spectrum" "{c}" {p}\n'
                        'Material "matte" "texture Kd" "t"\n')
       for c, p in (
           ("constant", '"rgb value" [0.2 0.4 0.6]'),
           ("checkerboard", '"rgb tex1" [1 0 0] "rgb tex2" [0 1 0]'),
           ("uv", ""), ("fbm", '"integer octaves" 5 "float roughness" 0.4'),
           ("wrinkled", '"float roughness" 0.7'),
           ("marble", '"float scale" 2.5'), ("windy", ""), ("dots", ""),
           ("scale", '"rgb tex1" [0.5 0.5 0.5] "rgb tex2" [1 0.2 0.3]'),
           ("mix", '"rgb tex1" [0 0 0] "rgb tex2" [1 1 1] "float amount" 0.7'),
           ("bilerp", '"rgb v00" [0 0 0] "rgb v11" [1 0.5 0.25]'),
           ("imagemap", '"string filename" "tex.pfm" "float uscale" 2 '
                        '"float vdelta" 0.25'))},
    "nested textures": (
        'Texture "a" "spectrum" "checkerboard" "rgb tex1" [1 0 0]\n'
        'Texture "b" "spectrum" "scale" "texture tex1" "a" "rgb tex2" [0.5 0.5 0.5]\n'
        'Texture "c" "spectrum" "mix" "texture tex1" "b" "texture tex2" "a"\n'
        'Material "plastic" "rgb Kd" [0.3 0.3 0.3]\n'
        'Material "matte" "texture Kd" "c"\n'),
    **{f"trianglemesh {k}": (
        'ReverseOrientation\n'
        f'Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ] '
        f'"point P" [ -1 -1 1  1 -1 1  1 1 1  -1 1 1 ] '
        f'"float {k}" [ 0 0  2 0.5  1.5 2  -0.5 1 ]\n') for k in ("uv", "st")},
    "materials with parameters": (
        'MakeNamedMaterial "g" "string type" "glass" "rgb Kr" [0.9 0.8 0.7] '
        '"rgb Kt" [0.6 0.7 0.8] "float eta" 1.33\n'
        'MakeNamedMaterial "p" "string type" "uber" "rgb Kd" [0.1 0.2 0.3] '
        '"rgb Ks" [0.3 0.2 0.1] "float roughness" 0.05\n'
        'Material "mix" "string namedmaterial1" "g" '
        '"string namedmaterial2" "p" "rgb amount" [0.2 0.5 0.8]\n'
        'Material "metal" "float roughness" 0.2\n'
        'Material "substrate" "rgb Kd" [0.2 0.3 0.4] "float roughness" 0.3\n'
        'Material "translucent" "rgb Kd" [0.3 0.2 0.1]\n'
        'Material "mirror" "rgb Kr" [0.5 0.6 0.7]\n'),
}

NOT_PORTED = {
    **{f"material {m}": f'Material "{m}"\n' for m in (
        "hair", "subsurface", "kdsubsurface")},
    "material fourier": 'Material "fourier" "string bsdffile" "x.bsdf"\n',
    "material mix of mixes": (
        'MakeNamedMaterial "a" "string type" "matte"\n'
        'MakeNamedMaterial "b" "string type" "mix" '
        '"string namedmaterial1" "a" "string namedmaterial2" "a"\n'
        'Material "mix" "string namedmaterial1" "a" '
        '"string namedmaterial2" "b"\n'),
    **{f"camera {c}": f'Camera "{c}"\n' for c in (
        "orthographic", "realistic", "environment")},
}


# the shape statements that raised before the shapes slice, with real
# parameters; each is parsed under a CTM (a translation, a rotation and a
# scale) inside a medium interface
SHAPES = {
    "shape disk": 'Shape "disk" "float radius" 0.8 "float height" 0.2\n'
                  'Shape "disk" "float radius" 0.9 "float innerradius" 0.4\n',
    "shape cylinder": ('Shape "cylinder" "float radius" 0.3 '
                       '"float zmin" -0.2 "float zmax" 0.6\n'),
    "shape cone": 'Shape "cone" "float radius" 0.5 "float height" 1.2\n',
    "shape paraboloid": ('Shape "paraboloid" "float radius" 0.6 '
                         '"float zmax" 0.9\n'),
    "shape hyperboloid": 'Shape "hyperboloid"\n',
    "shape curve": (
        'Shape "curve" "point P" [ 0 0 0  0.3 0.5 0.1  0.6 -0.2 0.3  1 0.4 0'
        '  1.2 0.8 0.2  1.4 0.6 0.5  1.6 1 0.3 ] "float width0" 0.05 '
        '"float width1" 0.02\n'
        'Shape "curve" "string type" "cylinder" "point P" [ 0 0 0  0 0.5 0'
        '  0.5 0.5 0  0.5 1 0.2 ] "float width" 0.04\n'
        'Shape "curve" "string type" "ribbon" "point P" [ 0 0 0  0.2 0.4 0'
        '  0.6 0.4 0.1  1 0 0 ] "normal N" [ 0 0 1  0 1 1 ] '
        '"float width" 0.06\n'),
    "shape curve ribbon with one normal": (
        'Shape "curve" "string type" "ribbon" "point P" [ 0 0 0  0.2 0.4 0'
        '  0.6 0.4 0.1  1 0 0 ] "normal N" [ 0 0 1 ]\n'),
    "shape loopsubdiv": (
        'Shape "loopsubdiv" "integer nlevels" 2 "integer indices" '
        '[ 0 1 2  0 2 3  0 3 1  1 3 2 ] '
        '"point P" [ 0 0 0  1 0 0  0 1 0  0 0 1 ]\n'
        'Shape "loopsubdiv" "integer indices" [ 0 1 2  0 2 3 ] '
        '"point P" [ 0 0 0  1 0 0  1 1 0.1  0 1 0.3 ]\n'),
    "shape nurbs": (
        'Shape "nurbs" "integer nu" 3 "integer nv" 3 "integer uorder" 3 '
        '"integer vorder" 3 "float uknots" [ 0 0 0 1 1 1 ] '
        '"float vknots" [ 0 0 0 1 1 1 ] "float u0" 0 "float u1" 1 '
        '"float v0" 0 "float v1" 1 "point P" [ 0 0 0  0.5 0 0.3  1 0 0 '
        ' 0 0.5 0.2  0.5 0.5 0.9  1 0.5 0.1  0 1 0  0.5 1 0.4  1 1 0 ]\n'
        'Shape "nurbs" "integer nu" 3 "integer nv" 2 "integer uorder" 2 '
        '"integer vorder" 2 "float uknots" [ 0 0 0.5 1 1 ] '
        '"float vknots" [ 0 0 1 1 ] "point P" [ 0 0 0  0.5 0 0.5  1 0 0 '
        ' 0 1 0  0.5 1 0.25  1 1 0 ] "float Pw" [ 1 2 1 1 0.5 1 ]\n'),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_shapes_parse_as_reference(case):
    """What raised before the shapes slice now builds bit for bit as the
    reference's scene: the quadrics about the CTM's z axis, the curve's
    three types ("flat", the default, facing the camera's eye; a ribbon's
    normals through the inverse CTM), Loop subdivision at its default 3
    levels and at 2, a NURBS patch with and without rational weights (the
    reference reads "Pw" as one weight per control point of "P")."""
    text = (HEAD + "WorldBegin\n"
            'MakeNamedMedium "fog" "string type" "homogeneous"\n'
            "AttributeBegin\n"
            'MediumInterface "fog" ""\n'
            'Material "matte" "rgb Kd" [ .5 .4 .3 ]\n'
            "Translate 0.5 -0.25 1\nRotate 35 0.2 1 0.4\nScale 1 1.5 0.8\n"
            + SHAPES[case] + "AttributeEnd\n" + MESH + "WorldEnd\n")
    if "one normal" in case:  # a malformed curve warns and is skipped
        with pytest.warns(UserWarning, match="ribbon curve needs two"):
            mine = tparser.parse_string(text, device="cpu")
        with pytest.warns(UserWarning, match="ribbon curve needs two"):
            ref = jparser.parse_string(text)
    else:
        mine, ref = (tparser.parse_string(text, device="cpu"),
                     jparser.parse_string(text))
    assert_parsed_equal(mine, ref)
    assert (mine.build(device="cpu").n_triangles == 2) == ("one normal"
                                                           in case)


@pytest.mark.parametrize("case", sorted(SURFACE) + GLASS_PBRT)
def test_surface_materials_parse_as_reference(case, tmp_path):
    """What raised before the surface-material slice now builds: the glass
    scenes and each material and texture statement, bit for bit the
    reference's scene."""
    if case in GLASS_PBRT:
        full = os.path.join(ROOT, case)
        mine, ref = (tparser.parse_file(full, device="cpu"),
                     jparser.parse_file(full))
    else:
        write_pfm(tmp_path / "tex.pfm", np.random.RandomState(0).rand(
            6, 10, 3).astype(np.float32))
        text = HEAD + "WorldBegin\n" + SURFACE[case] + MESH + "WorldEnd\n"
        mine, ref = (tparser.parse_string(text, tmp_path, device="cpu"),
                     jparser.parse_string(text, tmp_path))
        if case == "texture imagemap":
            assert mine.build(device="cpu").textures.atlas.shape[0] > 1
    assert_parsed_equal(mine, ref)


# the light sources that raised before the lights slice: each under a CTM
# (a translation, a rotation and a scale), with "scale", a medium
# interface, and a PFM map under "mapname" where the light reads one
LIGHTS = {
    "light distant": ('LightSource "distant" "point from" [ 0 1 0 ] '
                      '"point to" [ 0.3 0 0.9 ] "rgb L" [ 1 0.9 0.8 ] '
                      '"rgb scale" [ 2 2 2 ]\n'),
    "light infinite": ('LightSource "infinite" "rgb L" [ 0.5 0.6 0.7 ] '
                       '"string mapname" "env.pfm" "rgb scale" [ 1.5 1 1 ]\n'
                       'LightSource "infinite" "rgb L" [ 0.1 0.1 0.1 ]\n'),
    "light spot": ('LightSource "spot" "point from" [ 0 2 0 ] '
                   '"point to" [ 0.2 0 0.5 ] "rgb I" [ 5 4 3 ] '
                   '"float coneangle" 25 "float conedeltaangle" 8 '
                   '"rgb scale" [ 0.5 0.5 0.5 ]\n'),
    "light goniometric": ('LightSource "goniometric" "rgb I" [ 2 2 2 ] '
                          '"string mapname" "gonio.pfm" '
                          '"rgb scale" [ 1 2 3 ]\n'),
    "light projection": ('LightSource "projection" "rgb I" [ 3 3 3 ] '
                         '"string mapname" "slide.pfm" "float fov" 35 '
                         '"rgb scale" [ 2 1 1 ]\n'),
}


@pytest.mark.parametrize("case", sorted(LIGHTS))
def test_lights_parse_as_reference(case, tmp_path):
    """What raised before the lights slice now builds bit for bit as the
    reference's scene: "scale" multiplies I or L, from/to go through the
    CTM, the infinite and goniometric lights take inv(CTM) as their
    world-to-light, the projection light aims from CTM (0,0,0) to
    CTM (0,0,1), and "mapname" reads a PFM beside the file."""
    rs = np.random.RandomState(7)
    for name, shape in (("env.pfm", (8, 16, 3)), ("gonio.pfm", (6, 12, 3)),
                        ("slide.pfm", (8, 8, 3))):
        write_pfm(tmp_path / name, (0.1 + rs.rand(*shape)).astype(np.float32))
    text = (HEAD + "WorldBegin\n"
            'MakeNamedMedium "fog" "string type" "homogeneous"\n'
            "AttributeBegin\n"
            'MediumInterface "" "fog"\n'
            "Translate 0.5 1.5 -0.25\nRotate 35 0.2 1 0.4\nScale 1 1.5 1\n"
            + LIGHTS[case] + "AttributeEnd\n" + MESH + "WorldEnd\n")
    mine, ref = (tparser.parse_string(text, tmp_path, device="cpu"),
                 jparser.parse_string(text, tmp_path))
    assert_parsed_equal(mine, ref)
    lights = mine.build(device="cpu").lights
    assert lights.ltype.shape[0] >= 1
    if "mapname" in LIGHTS[case]:
        assert int(lights.img_off[0]) == 0 and lights.atlas.shape[0] > 1


def _write_assets(directory):
    """A Fourier table and a singlet lens file beside the scene (no asset
    is downloaded: tests/test_fourier.py and test_realistic_camera.py write
    their own)."""
    from bre_tpu_torch.fourier import (lambertian_fourier_table,
                                       write_bsdf_file)

    write_bsdf_file(directory / "x.bsdf",
                    lambertian_fourier_table(rho=0.7, n_mu=12))
    (directory / "singlet.dat").write_text(
        "# biconvex singlet\n50 5 1.5 30\n0 2 0 6\n-50 45 1 30\n")


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_raises_naming_roadmap_item(case, tmp_path):
    """The name is from when these statements raised NotImplementedError
    (the old raise list, ROADMAP Queue 1 items 5.7-5.8).  Each now parses
    without it and builds the reference's scene and camera; a realistic
    camera with no lens file warns and falls back to perspective, as
    there."""
    _write_assets(tmp_path)
    text = NOT_PORTED[case]
    if case.startswith("camera"):
        text = text + "WorldBegin\n" + MESH + "WorldEnd\n"
    else:
        text = HEAD + "WorldBegin\n" + text + MESH + "WorldEnd\n"
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        mine = tparser.parse_string(text, tmp_path, device="cpu")
    ref = jparser.parse_string(text, tmp_path)
    assert_parsed_equal(mine, ref)
    if case == "camera realistic":
        assert any("lens" in str(w.message) for w in got)
        assert mine.camera.ctype == 0


NEW_STATEMENTS = {
    "camera perspective thin lens": HEAD,
    "camera orthographic": 'LookAt 0.5 1 -4  0 0.2 0  0 1 0\n'
                           'Camera "orthographic"\n',
    "camera environment": 'LookAt 0.5 1 -4  0 0.2 0  0 1 0\n'
                          'Camera "environment"\n',
    "camera realistic": ('LookAt 0.5 1 -4  0 0.2 0  0 1 0\n'
                         'Camera "realistic" "string lensfile" "singlet.dat" '
                         '"float aperturediameter" 4 "float focusdistance" 2.5'
                         ' "float filmdiag" 30\n'),
    "camera realistic missing file": (
        'Camera "realistic" "string lensfile" "none.dat"\n'),
    "material hair": (
        'Material "hair" "rgb sigma_a" [0.2 0.3 0.4] "float beta_m" 0.2 '
        '"float beta_n" 0.4 "float alpha" 3 "float eta" 1.5\n'),
    "material hair color": 'Material "hair" "rgb color" [0.6 0.4 0.2]\n',
    "material hair melanin": ('Material "hair" "float eumelanin" 0.8 '
                              '"float pheomelanin" 0.3\n'),
    "material fourier": 'Material "fourier" "string bsdffile" "x.bsdf"\n',
    "material fourier no file": 'Material "fourier"\n',
    "material subsurface": (
        'Material "subsurface" "rgb sigma_a" [0.01 0.02 0.03] '
        '"rgb sigma_s" [1 2 3] "float scale" 4 "float eta" 1.4 '
        '"float g" 0.2\n'),
    "material subsurface named": ('Material "subsurface" "string name" '
                                  '"Ketchup"\n'),
    "material kdsubsurface": ('Material "kdsubsurface" "rgb Kd" [0.3 0.5 0.7]'
                              ' "rgb mfp" [0.5 1 2] "float eta" 1.5\n'),
    "material mix of mixes": (
        'MakeNamedMaterial "h" "string type" "hair"\n'
        'MakeNamedMaterial "g" "string type" "glass"\n'
        'MakeNamedMaterial "m" "string type" "mix" '
        '"string namedmaterial1" "h" "string namedmaterial2" "g"\n'
        'Material "mix" "string namedmaterial1" "m" '
        '"string namedmaterial2" "h" "rgb amount" [0.2 0.4 0.6]\n'),
}


@pytest.mark.parametrize("case", sorted(NEW_STATEMENTS))
def test_new_statements_parse_as_reference(case, tmp_path):
    """Every camera and material statement of ROADMAP Queue 1 items
    5.7-5.8, with its parameters, bit for bit the reference's scene (the
    BSSRDF and Fourier tables included) and camera (kind, lens, the
    realistic camera's autofocused stack)."""
    _write_assets(tmp_path)
    text = NEW_STATEMENTS[case]
    if case.startswith("camera"):  # HEAD's Film, Sampler, etc. kept
        head = HEAD if text == HEAD else HEAD.split("LookAt")[0] + text
        text = head + "WorldBegin\n" + MESH + "WorldEnd\n"
    else:
        text = HEAD + "WorldBegin\n" + text + MESH + "WorldEnd\n"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mine = tparser.parse_string(text, tmp_path, device="cpu")
        ref = jparser.parse_string(text, tmp_path)
    assert_parsed_equal(mine, ref)
    assert mine.camera.ctype == int(np.asarray(ref.camera.ctype))


def test_transform_needs_brackets():
    with pytest.raises(ValueError, match="expected"):
        tparser.parse_string("Transform 1 0 0 0", device="cpu")



def test_native_build_keyed_by_source_and_raises_on_failure(tmp_path,
                                                            monkeypatch):
    from bre_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    lib = native.build_library("image_filters.cpp")
    assert lib.parent.parent == tmp_path and lib.name == "libimage_filters.so"
    assert native.build_library("image_filters.cpp") == lib  # cached
    monkeypatch.setattr(native, "GXX_FLAGS", ("-O2", "-shared", "-fPIC",
                                              "--no-such-flag"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        native.build_library("image_filters.cpp")
