""".pbrt scene-language parser and graphics-state machine (counterpart of
``bre_tpu/scene/parser.py``; pbrt's pbrtlex.ll / pbrtparse.y driving
api.cpp).

A tokenizer and a statement loop feed the port's
:class:`~bre_tpu_torch.scene.builder.SceneBuilder`; the CTM stack, the
graphics state (material, area light, medium interface, orientation) and the
named materials, media and coordinate systems live only while parsing.  The
CTM and every transformed point are computed in numpy float32 with the
reference's expressions, so ``parse_file(p).build()`` equals
``scene_from_jax(bre_tpu parse_file(p).build())`` bit for bit.

Two kinds of input, as the reference treats them:
- directives, materials, lights, shapes and media the reference does not
  know either: warn and skip, or fall back (matte, a point light,
  perspective), exactly as the reference does;
- everything else: built as the reference builds it.  Every statement the
  reference builds is among them.  The quadrics, curves, Loop subdivision
  surfaces and NURBS patches become the builder's triangles; a quadric's
  axis is the CTM's z axis, a "flat" curve (the default type) faces the
  camera's eye, a ribbon's two normals go through the inverse CTM, and a
  malformed curve warns and is skipped, as there.  Every camera (the
  perspective with its thin lens, orthographic, environment, and the
  realistic camera with its lens file, read beside the including file) and
  every material (hair, fourier with its ``.bsdf`` file, subsurface,
  kdsubsurface, and a mix of mixes) is built.  ``TransformTimes`` only
  warns, as there: camera motion is the programmatic ``core.animated``.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..bssrdf import get_medium_scattering_properties
from ..core import transform as tfm
from ..io.image import read_image
from ..io.ply import read_ply
from .builder import SceneBuilder
from .camera import (Camera, make_environment_camera,
                     make_orthographic_camera, make_perspective_camera,
                     make_realistic_camera)
from .scene import LIGHT_DIFFUSE_AREA, SHAPE_TRIANGLE

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]#]+|#[^\n]*')


def tokenize(text: str) -> List[str]:
    """Lex a .pbrt file into tokens (strings keep their quotes, comments are
    dropped): the reference's regex lexer (pbrtlex.ll's token classes)."""
    return [t for t in _TOKEN_RE.findall(text) if not t.startswith("#")]


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


class _TokenStream:
    def __init__(self, tokens: List[str], include_dir: Path):
        self.toks = tokens
        self.pos = 0
        self.include_dir = include_dir

    def peek(self) -> Optional[str]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> str:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def done(self) -> bool:
        return self.pos >= len(self.toks)


def parse_params(ts: _TokenStream) -> Dict[str, object]:
    """Parse a ParamSet: a sequence of '"type name" value-or-[values]'."""
    params: Dict[str, object] = {}
    while True:
        t = ts.peek()
        if t is None or not (t.startswith('"') and " " in t):
            break
        decl = ts.next().strip('"')
        ptype, pname = decl.split(None, 1)
        vals: List[object] = []
        if ts.peek() == "[":
            ts.next()
            while ts.peek() != "]":
                vals.append(ts.next())
            ts.next()
        else:
            vals.append(ts.next())

        def conv(v):
            v = v.strip('"') if isinstance(v, str) and v.startswith('"') else v
            if ptype in ("integer",):
                return int(float(v))
            if ptype in ("float", "point", "point3", "point2", "vector", "vector3",
                         "normal", "normal3", "rgb", "color", "spectrum", "blackbody"):
                return float(v)
            if ptype == "bool":
                return str(v).strip('"') == "true"
            return str(v)

        conv_vals = [conv(v) for v in vals]
        params[pname] = conv_vals[0] if len(conv_vals) == 1 and ptype in (
            "integer", "float", "bool", "string", "texture",
        ) else conv_vals
    return params


def _p3(params, name, default):
    v = params.get(name)
    if v is None:
        return np.asarray(default, np.float32)
    a = np.asarray(v, np.float32).reshape(-1)
    return a[:3] if a.size >= 3 else np.full(3, a[0], np.float32)


def _f(params, name, default):
    v = params.get(name, default)
    if isinstance(v, list):
        v = v[0]
    return float(v)


def _i(params, name, default):
    v = params.get(name, default)
    if isinstance(v, list):
        v = v[0]
    return int(v)


@dataclasses.dataclass
class _GraphicsState:
    material: int = -1
    area_light: Optional[Dict] = None
    inside_medium: int = -1
    outside_medium: int = -1
    reverse_orientation: bool = False


@dataclasses.dataclass
class ParsedScene:
    builder: SceneBuilder
    camera: Optional[Camera]
    width: int
    height: int
    integrator_name: str
    integrator_params: Dict
    sampler_name: str
    sampler_params: Dict
    filter_name: str
    filename: str
    # Film post-ops (film.cpp): crop window as (x0, x1, y0, y1) fractions of
    # the resolution, or None; scale multiplies written pixel values.
    crop: object = None
    film_scale: float = 1.0
    # Film "maxsampleluminance" (a per-sample clamp of the sampler-driven
    # integrators; the photon-beam path does not read it)
    max_sample_luminance: float = float("inf")

    def build(self, device="cuda"):
        return self.builder.build(device=device)


def parse_string(text: str, include_dir: Path = Path("."),
                 device="cuda") -> ParsedScene:
    """Parse ``.pbrt`` text; ``Include`` paths are relative to
    ``include_dir``.  The camera is made on ``device``."""
    ts = _TokenStream(tokenize(text), include_dir)
    b = SceneBuilder()
    gs = _GraphicsState()
    gs_stack: List[_GraphicsState] = []
    ctm = np.eye(4, dtype=np.float32)
    ctm_stack: List[np.ndarray] = []
    named_coords: Dict[str, np.ndarray] = {}
    named_materials: Dict[str, int] = {}
    named_media: Dict[str, int] = {}
    named_textures: Dict[str, int] = {}

    cam_to_world: Optional[np.ndarray] = None
    cam_params: Dict = {}
    cam_type = "perspective"
    width, height = 640, 480
    filename = "pbrt.exr"
    crop = None
    film_scale = 1.0
    max_lum = float("inf")
    integ_name, integ_params = "path", {}
    samp_name, samp_params = "halton", {}
    filt_name = "box"
    in_world = False

    def apply(m):
        nonlocal ctm
        ctm = ctm @ np.asarray(m, np.float32)

    def xf_point(p):
        return (ctm[:3, :3] @ np.asarray(p, np.float32)) + ctm[:3, 3]

    def load_map(params: Dict, key: str = "mapname"):
        """The image a light's "mapname" (or "filename") or an imagemap's
        "filename" names, relative to the including file; a file that
        cannot be read warns and gives None, as the reference's does
        (parser.py:180-193)."""
        fname = params.get(key, params.get("filename"))
        if not isinstance(fname, str):
            return None
        path = ts.include_dir / fname.strip('"')
        try:
            return np.asarray(read_image(str(path)), np.float32)
        except Exception as e:
            warnings.warn(f"cannot read image map '{path}': {e}")
            return None

    def make_material(mat_type: str, params: Dict) -> int:
        """The reference's make_material (parser.py:215-294): its
        parameters and defaults for the ported kinds."""
        if mat_type == "matte":
            kd = params.get("Kd")
            if isinstance(kd, str):  # "texture Kd" "name"
                return b.matte((1.0, 1.0, 1.0), _f(params, "sigma", 0.0),
                               kd_tex=named_textures.get(kd.strip('"'), -1))
            return b.matte(_p3(params, "Kd", (0.5, 0.5, 0.5)),
                           _f(params, "sigma", 0.0))
        if mat_type == "mirror":
            return b.mirror(_p3(params, "Kr", (0.9, 0.9, 0.9)))
        if mat_type == "glass":
            return b.glass(_p3(params, "Kr", (1, 1, 1)),
                           _p3(params, "Kt", (1, 1, 1)),
                           _f(params, "eta", _f(params, "index", 1.5)))
        if mat_type == "metal":
            return b.metal(roughness=_f(params, "roughness", 0.01))
        if mat_type in ("plastic", "uber"):
            make = b.plastic if mat_type == "plastic" else b.uber
            return make(_p3(params, "Kd", (0.25,) * 3),
                        _p3(params, "Ks", (0.25,) * 3),
                        _f(params, "roughness", 0.1))
        if mat_type == "substrate":
            return b.substrate(_p3(params, "Kd", (0.5,) * 3),
                               _p3(params, "Ks", (0.5,) * 3),
                               _f(params, "roughness", 0.1))
        if mat_type == "translucent":
            return b.translucent(_p3(params, "Kd", (0.25,) * 3))
        if mat_type == "hair":
            kw = {}
            if "sigma_a" in params:
                kw["sigma_a"] = _p3(params, "sigma_a", (0.5,) * 3)
            elif "color" in params:
                kw["color"] = _p3(params, "color", (0.5,) * 3)
            elif "eumelanin" in params or "pheomelanin" in params:
                kw["eumelanin"] = _f(params, "eumelanin", 1.3)
                kw["pheomelanin"] = _f(params, "pheomelanin", 0.0)
            return b.hair(beta_m=_f(params, "beta_m", 0.3),
                          beta_n=_f(params, "beta_n", 0.3),
                          alpha=_f(params, "alpha", 2.0),
                          eta=_f(params, "eta", 1.55), **kw)
        if mat_type == "fourier":
            fn = str(params.get("bsdffile", "")).strip('"')
            if not fn:
                warnings.warn("fourier material needs bsdffile; using matte")
                return b.matte()
            return b.fourier_material(bsdffile=str(ts.include_dir / fn))
        if mat_type == "subsurface":
            kw = {}
            if "name" in params:
                kw["name"] = str(params["name"]).strip('"')
            if "sigma_a" in params:
                kw["sigma_a"] = _p3(params, "sigma_a", (0.0011, 0.0024, 0.014))
            if "sigma_s" in params:
                kw["sigma_s"] = _p3(params, "sigma_s", (2.55, 3.21, 3.77))
            return b.subsurface(g=_f(params, "g", 0.0),
                                eta=_f(params, "eta", 1.33),
                                scale=_f(params, "scale", 1.0),
                                kr=_p3(params, "Kr", (1.0,) * 3),
                                kt=_p3(params, "Kt", (1.0,) * 3), **kw)
        if mat_type == "kdsubsurface":
            return b.kdsubsurface(kd=_p3(params, "Kd", (0.5,) * 3),
                                  mfp=_p3(params, "mfp", (1.0,) * 3),
                                  g=_f(params, "g", 0.0),
                                  eta=_f(params, "eta", 1.33),
                                  scale=_f(params, "scale", 1.0),
                                  kr=_p3(params, "Kr", (1.0,) * 3),
                                  kt=_p3(params, "Kt", (1.0,) * 3))
        if mat_type == "mix":
            m1 = named_materials.get(
                str(params.get("namedmaterial1", "")).strip('"'), -1)
            m2 = named_materials.get(
                str(params.get("namedmaterial2", "")).strip('"'), -1)
            if m1 < 0 or m2 < 0:
                warnings.warn("mix material needs namedmaterial1/2")
                return b.matte()
            return b.mix(m1, m2, _p3(params, "amount", (0.5,) * 3))
        if mat_type in ("", "none"):
            return -1
        warnings.warn(f"material '{mat_type}' not implemented; using matte")
        return b.matte(_p3(params, "Kd", (0.5, 0.5, 0.5)))

    def make_texture(tname: str, tclass: str, p: Dict) -> None:
        """The reference's Texture statement (parser.py:403-462): the 12
        classes with its parameters and defaults; tex1/tex2 may name
        textures."""
        if tclass == "imagemap":
            img = load_map(p, "filename")
            if img is not None:
                named_textures[tname] = b.tex_imagemap(
                    img, uscale=_f(p, "uscale", 1.0),
                    vscale=_f(p, "vscale", 1.0), udelta=_f(p, "udelta", 0.0),
                    vdelta=_f(p, "vdelta", 0.0))
        elif tclass in ("checkerboard", "scale", "mix"):
            def arg(key, default):
                v = p.get(key)
                if isinstance(v, str):
                    return default, named_textures.get(v.strip('"'), -1)
                return _p3(p, key, default), -1

            if tclass == "checkerboard":
                (c1, r1), (c2, r2) = arg("tex1", (1, 1, 1)), arg("tex2", (0, 0, 0))
                named_textures[tname] = b.tex_checkerboard(c1, c2, tex1=r1,
                                                           tex2=r2)
            elif tclass == "scale":
                (c1, r1), (c2, r2) = arg("tex1", (1, 1, 1)), arg("tex2", (1, 1, 1))
                named_textures[tname] = b.tex_scale(c1, c2, tex1=r1, tex2=r2)
            else:
                (c1, r1), (c2, r2) = arg("tex1", (0, 0, 0)), arg("tex2", (1, 1, 1))
                named_textures[tname] = b.tex_mix(
                    c1, c2, amount=_f(p, "amount", 0.5), tex1=r1, tex2=r2)
        elif tclass == "constant":
            named_textures[tname] = b.tex_constant(_p3(p, "value", (1, 1, 1)))
        elif tclass in ("fbm", "wrinkled"):
            make = b.tex_fbm if tclass == "fbm" else b.tex_wrinkled
            named_textures[tname] = make(octaves=_i(p, "octaves", 8),
                                         omega=_f(p, "roughness", 0.5))
        elif tclass == "marble":
            named_textures[tname] = b.tex_marble(scale=_f(p, "scale", 1.0))
        elif tclass == "windy":
            named_textures[tname] = b.tex_windy()
        elif tclass == "uv":
            named_textures[tname] = b.tex_uv()
        elif tclass == "bilerp":
            named_textures[tname] = b.tex_bilerp(
                _p3(p, "v00", (0, 0, 0)), _p3(p, "v01", (1, 1, 1)),
                _p3(p, "v10", (0, 0, 0)), _p3(p, "v11", (1, 1, 1)))
        elif tclass == "dots":
            named_textures[tname] = b.tex_dots()
        else:
            warnings.warn(f"texture class '{tclass}' unsupported")

    while not ts.done():
        tok = ts.next()

        if tok == "Include":
            inc = ts.next().strip('"')
            inc_path = ts.include_dir / inc
            sub = tokenize(inc_path.read_text())
            ts.toks[ts.pos:ts.pos] = sub
        elif tok == "TransformTimes":
            ts.next(), ts.next()  # start, end
            warnings.warn(
                "TransformTimes: scene transforms are static here; camera "
                "motion blur is available programmatically via "
                "core.animated + generate_rays_animated")
        elif tok == "ActiveTransform":
            ts.next()  # StartTime | EndTime | All
        elif tok == "Identity":
            ctm = np.eye(4, dtype=np.float32)
        elif tok == "Translate":
            apply(np.asarray(tfm.translate([float(ts.next()) for _ in range(3)])))
        elif tok == "Scale":
            apply(np.asarray(tfm.scale(*[float(ts.next()) for _ in range(3)])))
        elif tok == "Rotate":
            vals = [float(ts.next()) for _ in range(4)]
            apply(np.asarray(tfm.rotate(vals[0], vals[1:])))
        elif tok == "LookAt":
            vals = [float(ts.next()) for _ in range(9)]
            # LookAt multiplies the CTM by world-to-camera, the inverse of
            # look_at's camera-to-world
            apply(np.linalg.inv(np.asarray(tfm.look_at(vals[0:3], vals[3:6],
                                                       vals[6:9]))))
        elif tok in ("Transform", "ConcatTransform"):
            if ts.next() != "[":
                raise ValueError(f"{tok}: expected '['")
            vals = [float(ts.next()) for _ in range(16)]
            if ts.next() != "]":
                raise ValueError(f"{tok}: expected ']' after 16 values")
            m = np.asarray(vals, np.float32).reshape(4, 4).T  # column-major input
            if tok == "Transform":
                ctm = m
            else:
                apply(m)
        elif tok == "CoordinateSystem":
            named_coords[ts.next().strip('"')] = ctm.copy()
        elif tok == "CoordSysTransform":
            name = ts.next().strip('"')
            if name in named_coords:
                ctm = named_coords[name].copy()
        elif tok == "Camera":
            cam_type = ts.next().strip('"')
            cam_params = parse_params(ts)
            cam_to_world = np.linalg.inv(ctm)
            named_coords["camera"] = np.linalg.inv(cam_to_world)
        elif tok == "Film":
            ts.next()  # "image"
            p = parse_params(ts)
            width = _i(p, "xresolution", 640)
            height = _i(p, "yresolution", 480)
            filename = str(p.get("filename", "pbrt.exr")).strip('"')
            film_scale = _f(p, "scale", 1.0)
            cw = p.get("cropwindow")
            if cw is not None:
                crop = tuple(float(v) for v in cw)
            max_lum = _f(p, "maxsampleluminance", float("inf"))
        elif tok == "Integrator":
            integ_name = ts.next().strip('"')
            integ_params = parse_params(ts)
        elif tok == "Sampler":
            samp_name = ts.next().strip('"')
            samp_params = parse_params(ts)
        elif tok == "PixelFilter":
            filt_name = ts.next().strip('"')
            parse_params(ts)
        elif tok == "Accelerator":
            ts.next()
            parse_params(ts)
        elif tok == "WorldBegin":
            in_world = True
            ctm = np.eye(4, dtype=np.float32)
        elif tok == "WorldEnd":
            in_world = False
        elif tok in ("AttributeBegin", "TransformBegin", "ObjectBegin"):
            if tok == "ObjectBegin":
                ts.next()  # name (instancing treated as inline)
            gs_stack.append(dataclasses.replace(gs))
            ctm_stack.append(ctm.copy())
        elif tok in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
            if gs_stack:
                gs = gs_stack.pop()
                ctm = ctm_stack.pop()
        elif tok == "ObjectInstance":
            ts.next()
        elif tok == "ReverseOrientation":
            gs.reverse_orientation = not gs.reverse_orientation
        elif tok == "Material":
            # pbrtMaterial does not clear a pending AreaLightSource: it
            # persists until AttributeEnd (api.cpp:1130-1137 vs :1216-1227)
            mat_type = ts.next().strip('"')
            gs.material = make_material(mat_type, parse_params(ts))
        elif tok == "MakeNamedMaterial":
            name = ts.next().strip('"')
            p = parse_params(ts)
            named_materials[name] = make_material(
                str(p.get("type", "matte")).strip('"'), p)
        elif tok == "NamedMaterial":
            name = ts.next().strip('"')
            gs.material = named_materials.get(name, -1)
        elif tok == "Texture":
            # Texture "name" "spectrum|float" "class" params (api.cpp
            # pbrtTexture)
            tname = ts.next().strip('"')
            ts.next()  # value type
            tclass = ts.next().strip('"')
            make_texture(tname, tclass, parse_params(ts))
        elif tok == "MakeNamedMedium":
            name = ts.next().strip('"')
            p = parse_params(ts)
            mtype = str(p.get("type", "homogeneous")).strip('"')
            sa = _p3(p, "sigma_a", (1, 1, 1))
            ss = _p3(p, "sigma_s", (1, 1, 1))
            preset = str(p.get("preset", "")).strip('"')
            if preset:
                # measured scattering table (MakeMedium, medium.cpp:49-195:
                # "preset" overrides sigma_a/sigma_s)
                props = get_medium_scattering_properties(preset)
                if props is None:
                    warnings.warn(f"medium preset '{preset}' unknown")
                else:
                    ss, sa = props
            g = _f(p, "g", 0.0)
            scale = _f(p, "scale", 1.0)
            if mtype == "homogeneous":
                named_media[name] = b.homogeneous_medium(sa * scale, ss * scale, g)
            elif mtype == "heterogeneous":
                nx = _i(p, "nx", 1)
                ny = _i(p, "ny", 1)
                nz = _i(p, "nz", 1)
                dens = np.asarray(p.get("density", [1.0]), np.float32).reshape(nz, ny, nx)
                p0 = _p3(p, "p0", (0, 0, 0))
                p1 = _p3(p, "p1", (1, 1, 1))
                # medium-to-world = ctm * translate(p0) * scale(p1-p0)
                m2w = ctm @ np.asarray(tfm.translate(p0)) @ np.asarray(
                    tfm.scale(*(p1 - p0))
                )
                named_media[name] = b.grid_medium(
                    dens, np.linalg.inv(m2w), sa * scale, ss * scale, g
                )
            else:
                warnings.warn(f"medium type '{mtype}' unsupported")
        elif tok == "MediumInterface":
            inside = ts.next().strip('"')
            outside = ts.next().strip('"') if (ts.peek() or "").startswith('"') else ""
            gs.inside_medium = named_media.get(inside, -1)
            gs.outside_medium = named_media.get(outside, -1)
            if not in_world:
                b.camera_medium = named_media.get(outside, named_media.get(inside, -1))
        elif tok == "LightSource":
            ltype = ts.next().strip('"')
            p = parse_params(ts)
            scale_ = _p3(p, "scale", (1, 1, 1))
            if ltype == "point":
                I = _p3(p, "I", (1, 1, 1)) * scale_
                from_ = xf_point(_p3(p, "from", (0, 0, 0)))
                b.point_light(from_, I, medium=gs.outside_medium)
            elif ltype == "distant":
                L = _p3(p, "L", (1, 1, 1)) * scale_
                from_ = xf_point(_p3(p, "from", (0, 0, 0)))
                to = xf_point(_p3(p, "to", (0, 0, 1)))
                b.distant_light(to - from_, L)
            elif ltype == "infinite":
                L = _p3(p, "L", (1, 1, 1)) * scale_
                b.infinite_light(L, image=load_map(p),
                                 world_to_light=np.linalg.inv(ctm))
            elif ltype == "spot":
                I = _p3(p, "I", (1, 1, 1)) * scale_
                from_ = xf_point(_p3(p, "from", (0, 0, 0)))
                to = xf_point(_p3(p, "to", (0, 0, 1)))
                b.spot_light(from_, to, I,
                             coneangle=_f(p, "coneangle", 30.0),
                             conedeltaangle=_f(p, "conedeltaangle", 5.0))
            elif ltype == "goniometric":
                I = _p3(p, "I", (1, 1, 1)) * scale_
                b.goniometric_light(xf_point((0, 0, 0)), I, image=load_map(p),
                                    world_to_light=np.linalg.inv(ctm),
                                    medium=gs.outside_medium)
            elif ltype == "projection":
                I = _p3(p, "I", (1, 1, 1)) * scale_
                b.projection_light(xf_point((0, 0, 0)), I, image=load_map(p),
                                   fov=_f(p, "fov", 45.0),
                                   target=xf_point((0, 0, 1)),
                                   medium=gs.outside_medium)
            else:
                warnings.warn(f"light '{ltype}' unsupported; treated as point")
                b.point_light(xf_point((0, 0, 0)), _p3(p, "I", (1, 1, 1)))
        elif tok == "AreaLightSource":
            ts.next()  # "diffuse"
            p = parse_params(ts)
            gs.area_light = dict(
                L=_p3(p, "L", (1, 1, 1)), twosided=bool(p.get("twosided", False))
            )
        elif tok == "Shape":
            stype = ts.next().strip('"')
            p = parse_params(ts)
            mi, mo = gs.inside_medium, gs.outside_medium
            if stype == "sphere":
                r = _f(p, "radius", 1.0)
                c = xf_point((0, 0, 0))
                if gs.area_light is not None:
                    b.area_light_sphere(
                        c, r, gs.area_light["L"], material=gs.material,
                        two_sided=gs.area_light["twosided"], medium=mo,
                        medium_inside=mi,
                    )
                else:
                    b.sphere(c, r, material=gs.material, medium_inside=mi,
                             medium_outside=mo)
            elif stype in ("trianglemesh", "plymesh", "heightfield"):
                if stype == "plymesh":
                    # Shape "plymesh" "string filename" (plymesh.cpp via
                    # rply); path relative to the scene file like Include
                    fname = str(p.get("filename", "")).strip('"')
                    pts, tri_idx = read_ply(ts.include_dir / fname)
                    idx = [int(v) for v in tri_idx.reshape(-1)]
                elif stype == "heightfield":
                    # heightfield.cpp CreateHeightfield: an (nu x nv) height
                    # grid over [0,1]^2 in object space, tessellated into a
                    # triangle mesh (2 triangles per cell)
                    nu_, nv_ = _i(p, "nu", 2), _i(p, "nv", 2)
                    z = np.asarray(p.get("Pz", []), np.float32).reshape(
                        nv_, nu_)
                    xs, ys = np.meshgrid(
                        np.linspace(0.0, 1.0, nu_, dtype=np.float32),
                        np.linspace(0.0, 1.0, nv_, dtype=np.float32))
                    pts = np.stack([xs, ys, z], -1).reshape(-1, 3)
                    idx = []
                    for j_ in range(nv_ - 1):
                        for i_ in range(nu_ - 1):
                            v00 = j_ * nu_ + i_
                            v10, v01 = v00 + 1, v00 + nu_
                            v11 = v01 + 1
                            idx += [v00, v10, v11, v00, v11, v01]
                else:
                    idx = [int(v) for v in p.get("indices", [])]
                    pts = np.asarray(p.get("P", []), np.float32).reshape(-1, 3)
                pts_w = pts @ ctm[:3, :3].T + ctm[:3, 3]
                # per-vertex shading normals ("normal N"): transform by the
                # inverse-transpose (normal covariance), flip under
                # ReverseOrientation (api.cpp semantics)
                vns = None
                if stype == "trianglemesh" and "N" in p:
                    vns = np.asarray(p["N"], np.float32).reshape(-1, 3)
                    inv_t = np.linalg.inv(ctm[:3, :3]).T
                    vns = vns @ inv_t.T
                    vns /= np.maximum(
                        np.linalg.norm(vns, axis=-1, keepdims=True), 1e-12)
                    if gs.reverse_orientation:
                        vns = -vns
                # per-vertex texture coordinates: pbrt accepts "uv" or
                # "st" (triangle.cpp CreateTriangleMesh; obj2pbrt emits st)
                uvs = None
                if stype == "trianglemesh":
                    uvraw = p.get("uv", p.get("st"))
                    if uvraw is not None:
                        uvs = np.asarray(uvraw, np.float32).reshape(-1, 2)
                for k in range(0, len(idx), 3):
                    i0, i1, i2 = idx[k], idx[k + 1], idx[k + 2]
                    v0, v1, v2 = pts_w[i0], pts_w[i1], pts_w[i2]
                    nk = (None, None, None)
                    if vns is not None:
                        nk = (vns[i0], vns[i1], vns[i2])
                    uk = (None, None, None)
                    if uvs is not None:
                        uk = (uvs[i0], uvs[i1], uvs[i2])
                    if gs.reverse_orientation:
                        v1, v2 = v2, v1
                        nk = (nk[0], nk[2], nk[1])
                        uk = (uk[0], uk[2], uk[1])
                    if gs.area_light is not None:
                        light_id = len(b._light)
                        tidx = b.triangle(v0, v1, v2, material=gs.material,
                                          medium_inside=mi, medium_outside=mo,
                                          _area_light=light_id,
                                          n0=nk[0], n1=nk[1], n2=nk[2],
                                          uv0=uk[0], uv1=uk[1], uv2=uk[2])
                        b._add_light(
                            ltype=LIGHT_DIFFUSE_AREA,
                            position=(v0 + v1 + v2) / 3.0,
                            emit=np.asarray(gs.area_light["L"], np.float32),
                            shape_kind=SHAPE_TRIANGLE,
                            shape_index=tidx,
                            two_sided=int(gs.area_light["twosided"]),
                            medium=mo,
                        )
                    else:
                        b.triangle(v0, v1, v2, material=gs.material,
                                   medium_inside=mi, medium_outside=mo,
                                   n0=nk[0], n1=nk[1], n2=nk[2],
                                   uv0=uk[0], uv1=uk[1], uv2=uk[2])
            elif stype == "disk":
                b.disk(xf_point((0, 0, _f(p, "height", 0.0))),
                       normal=ctm[:3, 2], radius=_f(p, "radius", 1.0),
                       inner_radius=_f(p, "innerradius", 0.0),
                       material=gs.material, medium_inside=mi, medium_outside=mo)
            elif stype == "cylinder":
                b.cylinder(xf_point((0, 0, 0)), axis=ctm[:3, 2],
                           radius=_f(p, "radius", 1.0),
                           zmin=_f(p, "zmin", -1.0), zmax=_f(p, "zmax", 1.0),
                           material=gs.material, medium_inside=mi,
                           medium_outside=mo)
            elif stype == "cone":
                b.cone(xf_point((0, 0, 0)), axis=ctm[:3, 2],
                       radius=_f(p, "radius", 1.0),
                       height=_f(p, "height", 1.0),
                       material=gs.material, medium_inside=mi, medium_outside=mo)
            elif stype == "paraboloid":
                b.paraboloid(xf_point((0, 0, 0)), axis=ctm[:3, 2],
                             radius=_f(p, "radius", 1.0),
                             zmax=_f(p, "zmax", 1.0),
                             material=gs.material, medium_inside=mi,
                             medium_outside=mo)
            elif stype == "hyperboloid":
                b.hyperboloid(xf_point((0, 0, 0)), axis=ctm[:3, 2],
                              material=gs.material, medium_inside=mi,
                              medium_outside=mo)
            elif stype == "curve":
                cps = np.asarray(p.get("P", []), np.float32).reshape(-1, 3)
                cps = cps @ ctm[:3, :3].T + ctm[:3, 3]
                w0 = _f(p, "width0", _f(p, "width", 0.01))
                w1 = _f(p, "width1", _f(p, "width", 0.01))
                # CurveType (curve.cpp:399-410; reference default "flat");
                # ribbon takes two endpoint normals via "N" (curve.cpp:412-427)
                ct_s = str(p.get("type", "flat")).strip('"')
                if ct_s not in ("flat", "ribbon", "cylinder"):
                    warnings.warn(
                        f'unknown curve type "{ct_s}"; using "cylinder"')
                    ct_s = "cylinder"
                cn0 = cn1 = None
                if ct_s == "ribbon":
                    nn = np.asarray(p.get("N", []), np.float32).reshape(-1, 3)
                    if nn.shape[0] != 2:
                        warnings.warn('ribbon curve needs two "N" normals; '
                                      "skipped")
                        continue
                    nn = nn @ np.linalg.inv(ctm[:3, :3])  # normal transform
                    cn0, cn1 = nn[0], nn[1]
                eye = (np.asarray(cam_to_world, np.float32)[:3, 3]
                       if cam_to_world is not None else None)
                for k in range(0, max(len(cps) - 3, 0), 3):  # bezier chains
                    b.curve(cps[k:k + 4], width0=w0, width1=w1,
                            ctype=ct_s, n0=cn0, n1=cn1, facing=eye,
                            material=gs.material, medium_inside=mi,
                            medium_outside=mo)
            elif stype == "loopsubdiv":
                idx = [int(v) for v in p.get("indices", [])]
                pts = np.asarray(p.get("P", []), np.float32).reshape(-1, 3)
                pts = pts @ ctm[:3, :3].T + ctm[:3, 3]
                b.loopsubdiv(idx, pts, nlevels=_i(p, "nlevels", 3),
                             material=gs.material, medium_inside=mi,
                             medium_outside=mo)
            elif stype == "nurbs":
                nu_, nv_ = _i(p, "nu", 2), _i(p, "nv", 2)
                pts = np.asarray(p.get("P", []), np.float32).reshape(-1, 3)
                pts = pts @ ctm[:3, :3].T + ctm[:3, 3]
                b.nurbs(nu_, nv_, _i(p, "uorder", 2), _i(p, "vorder", 2),
                        np.asarray(p.get("uknots", []), np.float32),
                        np.asarray(p.get("vknots", []), np.float32),
                        pts, w=p.get("Pw"), material=gs.material,
                        medium_inside=mi, medium_outside=mo)
            else:
                warnings.warn(f"shape '{stype}' unsupported; skipped")
        else:
            if tok.startswith('"') or _is_number(tok) or tok in ("[", "]"):
                continue  # stray value from a skipped directive
            warnings.warn(f"unknown directive '{tok}' skipped")
            parse_params(ts)

    camera = None
    if cam_to_world is not None:
        c2w = np.asarray(cam_to_world)
        if cam_type == "perspective":
            # the thin lens is read by volpath alone, which passes lens
            # samples (bre_tpu/integrators/volpath.py:481-490)
            camera = make_perspective_camera(
                c2w, _f(cam_params, "fov", 90.0), width, height,
                lens_radius=_f(cam_params, "lensradius", 0.0),
                focal_distance=_f(cam_params, "focaldistance", 1e6),
                device=device)
        elif cam_type == "orthographic":
            camera = make_orthographic_camera(c2w, width, height,
                                              device=device)
        elif cam_type == "realistic":
            # the lens file beside the including file; a missing or empty
            # one warns and falls back to perspective (parser.py:746-768)
            lens_file = str(cam_params.get("lensfile", "")).strip('"')
            rows = []
            try:
                for line in (ts.include_dir / lens_file).read_text(
                        ).splitlines():
                    line = line.split("#")[0].strip()
                    if line:
                        rows.append([float(v) for v in line.split()])
            except OSError as e:
                warnings.warn(f"cannot read lens file '{lens_file}': {e}")
            if rows:
                camera = make_realistic_camera(
                    c2w, rows, width, height,
                    aperture_diameter=_f(cam_params, "aperturediameter", 1.0),
                    focus_distance=_f(cam_params, "focusdistance", 10.0),
                    film_diag=_f(cam_params, "filmdiag", 35.0) * 1e-3,
                    device=device)
            else:
                warnings.warn("realistic camera without lensfile; perspective")
                camera = make_perspective_camera(c2w, 45.0, width, height,
                                                 device=device)
        elif cam_type == "environment":
            camera = make_environment_camera(c2w, width, height,
                                             device=device)
        else:
            warnings.warn(f"camera '{cam_type}' unsupported; using perspective")
            camera = make_perspective_camera(
                np.asarray(cam_to_world), 90.0, width, height, device=device
            )

    return ParsedScene(
        builder=b, camera=camera, width=width, height=height,
        integrator_name=integ_name, integrator_params=integ_params,
        sampler_name=samp_name, sampler_params=samp_params,
        filter_name=filt_name, filename=filename,
        crop=crop, film_scale=film_scale, max_sample_luminance=max_lum,
    )


def parse_file(path, device="cuda") -> ParsedScene:
    """ParseFile (pbrt parser.cpp:45-66); the camera is made on
    ``device``."""
    p = Path(path)
    return parse_string(p.read_text(), include_dir=p.parent, device=device)
