"""Shared pieces of the bre_tpu_torch parity tests (tests/test_torch_*.py):
the Cornell fog scene on either package's builder and tensor -> numpy.

Torch runs single-threaded in every test process: the suite runs under
several pytest-xdist workers on a shared CPU."""

import numpy as np
import torch

torch.set_num_threads(1)


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def leaves(x, name=()):
    """(name, leaf) of every tensor or host value of a Scene part, the
    tables nested in it (the BSSRDF and Fourier tables) included."""
    if hasattr(x, "_fields"):
        for k in x._fields:
            yield from leaves(getattr(x, k), name + (k,))
    else:
        yield name, x


def pixels_close(a, b, rtol=1e-3, atol=1e-6, frac=0.99):
    """The parity tests' per-pixel check: ``frac`` of the pixels within
    rtol, atol in every channel."""
    close = np.isclose(to_np(a), to_np(b), rtol=rtol, atol=atol).all(-1)
    assert close.mean() >= frac, close.mean()


def region_means(img, n=4):
    """Means over an n x n grid of regions of an (H, W, 3) image."""
    img = to_np(img)
    H, W = img.shape[:2]
    return img.reshape(n, H // n, n, W // n, 3).mean(axis=(1, 3))


def pcg_state(s):
    """The 64-bit state of a bre_tpu PCG32State (uint32 hi, lo) as the
    port's int64 bit pattern."""
    v = (np.asarray(s.state_hi, np.uint64) << np.uint64(32)) | np.asarray(
        s.state_lo, np.uint64)
    return v.view(np.int64)


SMOKE_W2M = np.array([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5],
                      [0, 0, 0.5, 0.5], [0, 0, 0, 1]], np.float32)
SMOKE_LOOK = ((0, 0, -3.2), (0, 0, 0), (0, 1, 0))


def smoke_density(n=32):
    """examples/smoke_hetero.py's procedural density: an elongated puff
    with swirls on an n^3 grid."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    d = np.exp(-2.0 * (x**2 + 2 * y**2 + z**2))
    d *= 1.0 + 0.5 * np.sin(4 * x) * np.cos(3 * z)
    return np.clip(d, 0.0, None).astype(np.float32)


def smoke_hetero(b, density=None, g=0.4, **build_kw):
    """examples/smoke_hetero.py's scene (BASELINE config 3) on either
    package's SceneBuilder: the grid smoke in [-1,1]^3 lit from inside, a
    wall behind it."""
    dens = smoke_density() if density is None else density
    smoke = b.grid_medium(dens, SMOKE_W2M, sigma_a=(0.02,) * 3,
                          sigma_s=(0.6,) * 3, g=g)
    wall = b.matte((0.5, 0.5, 0.6))
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=smoke,
          medium_outside=-1)
    b.quad((-4, -4, 2.5), (-4, 4, 2.5), (4, 4, 2.5), (4, -4, 2.5),
           material=wall)
    b.point_light((0.0, 0.8, -0.5), (2.0, 1.9, 1.7), medium=smoke)
    return b.build(**build_kw)


def cornell_fog(b, point_light=False, **build_kw):
    """examples/cornell_fog.py's scene (BASELINE config 2) on either
    package's SceneBuilder; optionally one extra point light in the fog.
    ``build_kw`` goes to ``build`` (the port's takes ``device="cpu"``)."""
    fog = b.homogeneous_medium((0.02,) * 3, (0.35,) * 3, g=0.0)
    white = b.matte((0.73, 0.73, 0.73))
    red = b.matte((0.63, 0.065, 0.05))
    green = b.matte((0.14, 0.45, 0.09))
    b.box((-1, -1, 0), (1, 1, 2), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-1, -1, 2), (-1, 1, 2), (1, 1, 2), (1, -1, 2), material=white)
    b.quad((-1, -1, 0), (-1, -1, 2), (-1, 1, 2), (-1, 1, 0), material=red)
    b.quad((1, -1, 0), (1, 1, 0), (1, 1, 2), (1, -1, 2), material=green)
    b.quad((-1, -1, 0), (1, -1, 0), (1, -1, 2), (-1, -1, 2), material=white)
    b.quad((-1, 1, 0), (-1, 1, 2), (1, 1, 2), (1, 1, 0), material=white)
    b.area_light_quad((-0.3, 0.98, 0.7), (0.3, 0.98, 0.7),
                      (0.3, 0.98, 1.3), (-0.3, 0.98, 1.3),
                      (6.0, 5.5, 4.5), medium=fog)
    if point_light:
        b.point_light((0.2, -0.4, 1.1), (0.8, 0.9, 1.0), medium=fog)
    return b.build(**build_kw)


SURFACE_LOOK = ((0, 0.4, -4.5), (0, 0, 0), (0, 1, 0))
SURFACE_FOV = 42.0


def surface_scene(b, textured=True, **build_kw):
    """tests/test_photonbeam_vs_volpath.py's glass_caustic_scene (BASELINE
    config 4's shape: a glass sphere in fog, two point lights) with a
    mirror floor, a metal and a plastic sphere in the fog, and (with
    ``textured``) a checkerboard texture on the back wall, on either
    package's SceneBuilder.  Camera: SURFACE_LOOK, SURFACE_FOV."""
    fog = b.homogeneous_medium((0.02,) * 3, (0.35,) * 3, 0.0)
    b.box((-2, -2, -2), (2, 2, 2), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.sphere((0, 0, 0), 0.6, material=b.glass(eta=1.5), medium_outside=fog)
    mirror = b.mirror((0.9, 0.85, 0.8))
    b.quad((-1.8, -1.5, -1.8), (-1.8, -1.5, 1.8), (1.8, -1.5, 1.8),
           (1.8, -1.5, -1.8), material=mirror, medium_inside=fog,
           medium_outside=fog)
    b.sphere((1.1, -0.9, 0.6), 0.4, material=b.metal(roughness=0.15),
             medium_inside=fog, medium_outside=fog)
    b.sphere((-1.1, -0.9, 0.5), 0.45,
             material=b.plastic((0.5, 0.3, 0.2), (0.3, 0.3, 0.3), 0.2),
             medium_inside=fog, medium_outside=fog)
    tex = (b.tex_checkerboard((1, 1, 1), (0.2, 0.3, 0.5), scale=1.5)
           if textured else -1)
    wall = b.matte((0.6, 0.55, 0.5), kd_tex=tex)
    b.quad((-5, -5, 3.5), (-5, 5, 3.5), (5, 5, 3.5), (5, -5, 3.5),
           material=wall)
    b.point_light((1.5, 1.5, -1.5), (3.0, 2.8, 2.5), medium=fog)
    b.point_light((-1.5, 1.0, -1.0), (1.0, 1.2, 1.8), medium=fog)
    return b.build(**build_kw)


def every_material(b):
    """Every analytic material, two of some, a mix of two diffuse and a mix
    of two specular ones, a mix of mixes, subsurface and kdsubsurface
    (glass's BSDF), and a textured matte and plastic, on either
    package's SceneBuilder (a sphere holds material 0).  Returns their
    ids by name."""
    ids = dict(
        matte=b.matte((0.6, 0.5, 0.4)),
        mirror=b.mirror((0.9, 0.8, 0.7)),
        glass=b.glass(),
        glass_tinted=b.glass((0.9, 0.95, 1.0), (0.8, 0.9, 1.0), eta=1.33),
        metal=b.metal(roughness=0.01),
        metal_rough=b.metal(eta=(1.5, 0.9, 0.4), k=(2.0, 3.0, 4.0),
                            roughness=0.3, tint=(0.9, 0.8, 1.0)),
        plastic=b.plastic((0.4, 0.3, 0.2), (0.3, 0.3, 0.3), 0.2),
        uber=b.uber((0.2, 0.4, 0.3), (0.5, 0.4, 0.3), 0.05, eta=1.7),
        substrate=b.substrate((0.5, 0.4, 0.3), (0.2, 0.2, 0.2), 0.15),
        translucent=b.translucent((0.3, 0.4, 0.5), (0.4, 0.3, 0.2)),
    )
    ids["mix"] = b.mix(ids["matte"], ids["plastic"], (0.3, 0.6, 0.2))
    ids["mix_specular"] = b.mix(ids["glass"], ids["metal"], 0.5)
    ids["mix_of_mixes"] = b.mix(ids["mix"], ids["glass"], (0.6, 0.5, 0.4))
    ids["subsurface"] = b.subsurface(eta=1.4)
    ids["kdsubsurface"] = b.kdsubsurface(kd=(0.4, 0.6, 0.8))
    t = b.tex_checkerboard((1, 1, 1), (0.2, 0.3, 0.4), scale=3.0)
    ids["matte_tex"] = b.matte(kd_tex=t)
    ids["plastic_tex"] = b.plastic(kd_tex=b.tex_fbm(scale=2.0))
    b.sphere((0, 0, 0), 1.0, material=0)
    return ids


def glossy_fourier_table(n_mu=16, m_max=8):
    """A three-channel Fourier table projected from a Lambertian plus
    glossy reflection lobe (fourier.project_bsdf_table; no .bsdf asset is
    in the tree), the same numpy table for both packages."""
    from bre_tpu_torch.fourier import project_bsdf_table

    rgb = np.array([0.2, 0.6, 0.35])  # the file's channels: Y, R, B

    def f(mu_i, mu_o, phi):
        if mu_i * mu_o >= 0:
            return np.zeros((phi.shape[0], 3))
        c = np.sqrt(max(0.0, 1 - mu_i * mu_i) * max(0.0, 1 - mu_o * mu_o))
        lobe = np.exp(4.0 * (abs(mu_i * mu_o) - c * np.cos(phi) - 1.0))
        return (0.3 / np.pi + 0.5 * lobe)[:, None] * rgb

    return project_bsdf_table(f, n_mu=n_mu, m_max=m_max, n_channels=3,
                              eta=1.0)


def fiber_materials(b, table=None):
    """The measured and fiber materials on either package's SceneBuilder:
    two hairs, a Fourier table, subsurface and kdsubsurface (which scatter
    as glass), a mix holding a hair and a mix of mixes (a sphere holds
    material 0).  Returns their ids by name."""
    ids = dict(
        hair=b.hair(sigma_a=(0.25, 0.4, 0.8), beta_m=0.25, beta_n=0.35),
        hair_rough=b.hair(color=(0.6, 0.4, 0.2), beta_m=0.6, beta_n=0.7,
                          alpha=4.0, eta=1.5),
        fourier=b.fourier_material(
            table=table if table is not None else glossy_fourier_table()),
        subsurface=b.subsurface(eta=1.4),
        kdsubsurface=b.kdsubsurface(kd=(0.4, 0.6, 0.8), eta=1.33),
        matte=b.matte((0.6, 0.5, 0.4)),
    )
    ids["mix_hair"] = b.mix(ids["hair"], ids["matte"], (0.4, 0.5, 0.6))
    ids["mix_of_mixes"] = b.mix(ids["mix_hair"], ids["fourier"], 0.3)
    b.sphere((0, 0, 0), 1.0, material=0)
    return ids


IMAGE_LOOK = ((0, 0, 0), (0, 0, 4), (0, 1, 0))  # fov 40


def image_scene(b, **build_kw):
    """A minified image-checker plane (tests/test_ewa.py), an image-mapped
    plastic sphere and a uv-textured matte one, lit by a point light, on
    either package's SceneBuilder.  Camera: IMAGE_LOOK, fov 40."""
    n = 64
    xx, yy = np.meshgrid(np.arange(n), np.arange(n))
    img = np.zeros((n, n, 3), np.float32)
    img[((xx // 2 + yy // 2) % 2) == 0] = (1.0, 0.9, 0.7)
    checker = b.matte((1, 1, 1), kd_tex=b.tex_imagemap(img, uscale=3.0,
                                                       vscale=3.0))
    L = 6.0
    b.quad((-L, -L, 8), (L, -L, 8), (L, L, 8), (-L, L, 8), material=checker)
    photo = np.random.RandomState(0).rand(16, 32, 3).astype(np.float32)
    b.sphere((-1.0, 0.0, 4.0), 0.8,
             material=b.plastic(kd_tex=b.tex_imagemap(photo)))
    b.sphere((1.0, 0.3, 4.5), 0.7, material=b.matte(kd_tex=b.tex_uv()))
    b.point_light((0, 2, 0), (40, 40, 40))
    return b.build(**build_kw)


# the light kinds of the light tests: each of the seven types, the infinite
# light both constant and image-mapped
LIGHT_KINDS = ("point", "spot", "area", "sphere", "distant", "infinite",
               "envmap", "goniometric", "projection")


def _rot(deg, axis):
    """A 4x4 rotation about a unit axis (Rodrigues), float32."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    t = np.deg2rad(deg)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * (k @ k)
    return m.astype(np.float32)


def light_images(seed=0, env=(16, 32), gonio=(8, 16), slide=(8, 8)):
    """Seeded positive RGB images: an equirectangular env map (a bright
    patch on a dim sky), a goniometric map and a projector slide."""
    rs = np.random.RandomState(seed)
    h, w = env
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    patch = np.exp(-((yy - 0.3 * h) ** 2 / (0.02 * h * h)
                     + (xx - 0.6 * w) ** 2 / (0.02 * w * w)))
    env_img = (0.1 + 0.2 * rs.rand(h, w, 3)
               + 4.0 * patch[..., None] * np.array([1.0, 0.9, 0.7]))
    return (env_img.astype(np.float32),
            (0.2 + rs.rand(*gonio, 3)).astype(np.float32),
            (0.1 + rs.rand(*slide, 3)).astype(np.float32))


def add_lights(b, kinds, images, medium=-1):
    """One light of each of ``kinds`` (LIGHT_KINDS) on either package's
    SceneBuilder, about a box [-1,1] x [-1,1] x [0,2] whose front z=0 is
    open; area lights are one-sided quads and spheres of matte."""
    env, gonio, slide = images
    for k in kinds:
        if k == "point":
            b.point_light((0.3, 0.6, 0.8), (1.0, 0.9, 0.8), medium=medium)
        elif k == "spot":
            b.spot_light((0.0, 0.95, 1.0), (0.1, -1.0, 1.2), (6.0, 5.5, 5.0),
                         coneangle=35.0, conedeltaangle=10.0, medium=medium)
        elif k == "area":
            b.area_light_quad((-0.3, 0.98, 0.7), (0.3, 0.98, 0.7),
                              (0.3, 0.98, 1.3), (-0.3, 0.98, 1.3),
                              (4.0, 3.5, 3.0), medium=medium)
        elif k == "sphere":
            b.area_light_sphere((-0.6, -0.7, 1.5), 0.2, (2.0, 2.5, 3.0),
                                material=b.matte((0.5, 0.5, 0.5)),
                                medium=medium)
        elif k == "distant":
            b.distant_light((0.25, -0.35, 1.0), (0.9, 0.95, 1.0))
        elif k == "infinite":
            b.infinite_light((0.05, 0.06, 0.08))
        elif k == "envmap":
            b.infinite_light((0.8, 0.8, 0.8), image=env,
                             world_to_light=_rot(30.0, (1.0, 2.0, 0.5)))
        elif k == "goniometric":
            b.goniometric_light((-0.4, 0.7, 1.6), (0.8, 0.7, 0.9),
                                image=gonio,
                                world_to_light=_rot(-40.0, (0.3, 1.0, 0.2)),
                                medium=medium)
        elif k == "projection":
            b.projection_light((0.5, 0.8, 0.3), (5.0, 5.0, 4.0), image=slide,
                               fov=40.0, target=(-0.2, -1.0, 1.4),
                               medium=medium)
        else:
            raise ValueError(k)


def lights_scene(b, kinds=LIGHT_KINDS, seed=0, **build_kw):
    """A matte floor, back and side walls and ``kinds`` of light
    (add_lights), in vacuum, on either package's SceneBuilder."""
    m = b.matte((0.6, 0.55, 0.5))
    b.quad((-1, -1, 0), (1, -1, 0), (1, -1, 2), (-1, -1, 2), material=m)
    b.quad((-1, -1, 2), (-1, 1, 2), (1, 1, 2), (1, -1, 2), material=m)
    b.quad((-1, -1, 0), (-1, -1, 2), (-1, 1, 2), (-1, 1, 0),
           material=b.matte((0.63, 0.065, 0.05)))
    add_lights(b, kinds, light_images(seed))
    return b.build(**build_kw)


LIT_FOG_LIGHTS = ("spot", "distant", "envmap")


def lit_fog_box(b, kinds=LIT_FOG_LIGHTS, seed=0, **build_kw):
    """cornell_fog's box and fog lit by ``kinds`` of light (add_lights) in
    place of its ceiling area light, on either package's SceneBuilder;
    the distant and infinite lights reach in through the open front.
    Camera: cornell_fog's, look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)),
    fov 50."""
    fog = b.homogeneous_medium((0.02,) * 3, (0.35,) * 3, g=0.0)
    white = b.matte((0.73, 0.73, 0.73))
    red = b.matte((0.63, 0.065, 0.05))
    green = b.matte((0.14, 0.45, 0.09))
    b.box((-1, -1, 0), (1, 1, 2), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-1, -1, 2), (-1, 1, 2), (1, 1, 2), (1, -1, 2), material=white)
    b.quad((-1, -1, 0), (-1, -1, 2), (-1, 1, 2), (-1, 1, 0), material=red)
    b.quad((1, -1, 0), (1, 1, 0), (1, 1, 2), (1, -1, 2), material=green)
    b.quad((-1, -1, 0), (1, -1, 0), (1, -1, 2), (-1, -1, 2), material=white)
    b.quad((-1, 1, 0), (-1, 1, 2), (1, 1, 2), (1, 1, 0), material=white)
    add_lights(b, kinds, light_images(seed), medium=fog)
    return b.build(**build_kw)


ENV_SPHERE_LOOK = ((0.3, 0.4, -3.0), (0, 0, 0), (0, 1, 0))  # fov 60


def env_sphere(b, kinds=("distant", "envmap"), seed=0, **build_kw):
    """A matte sphere of radius 1 at the origin under ``kinds`` of light
    (add_lights), in vacuum, on either package's SceneBuilder; from
    ENV_SPHERE_LOOK the film's corners see the env map past it."""
    b.sphere((0, 0, 0), 1.0, material=b.matte((0.6, 0.55, 0.5)))
    add_lights(b, kinds, light_images(seed))
    return b.build(**build_kw)


# --- the extra shapes (ROADMAP Queue 1 items 5.5-5.6) ---

# examples/cornell_fog.pbrt's box, fog, light and camera; the shapes sit in
# the fog, with fog on both sides
_FOG_BOX_HEAD = """Integrator "photonbeam"
    "integer iterations" [ {iters} ]
    "integer photonsperiteration" [ {photons} ]
    "float initialbeamradius" [ 0.15 ]
    "integer maxdepth" [ 5 ]
Film "image" "integer xresolution" [ {size} ] "integer yresolution" [ {size} ]
    "string filename" "shapes_fog.pfm"
LookAt 0 1 -3.9   0 1 0   0 1 0
Camera "perspective" "float fov" 40

WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [ .02 .02 .02 ] "rgb sigma_s" [ .25 .25 .25 ] "float g" 0.2
AttributeBegin
  MediumInterface "" "fog"
  Material "matte" "rgb Kd" [ .73 .73 .73 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -1 0 -1   -1 0 1   1 0 1   1 0 -1 ]
  Shape "trianglemesh" "integer indices" [ 0 2 1 0 3 2 ]
      "point P" [ -1 2 -1   -1 2 1   1 2 1   1 2 -1 ]
  Shape "trianglemesh" "integer indices" [ 0 2 1 0 3 2 ]
      "point P" [ -1 0 1   -1 2 1   1 2 1   1 0 1 ]
AttributeEnd
AttributeBegin
  MediumInterface "" "fog"
  Material "matte" "rgb Kd" [ .65 .05 .05 ]
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -1 0 -1   -1 0 1   -1 2 1   -1 2 -1 ]
AttributeEnd
AttributeBegin
  MediumInterface "" "fog"
  Material "matte" "rgb Kd" [ .12 .45 .15 ]
  Shape "trianglemesh" "integer indices" [ 0 2 1 0 3 2 ]
      "point P" [ 1 0 -1   1 0 1   1 2 1   1 2 -1 ]
AttributeEnd
AttributeBegin
  MediumInterface "" "fog"
  AreaLightSource "diffuse" "rgb L" [ 9 8 6 ]
  Material "none"
  Shape "trianglemesh" "integer indices" [ 0 1 2 0 2 3 ]
      "point P" [ -0.3 1.99 -0.3   0.3 1.99 -0.3   0.3 1.99 0.3   -0.3 1.99 0.3 ]
AttributeEnd
"""

_FOG_BOX_SHAPES = """AttributeBegin
  MediumInterface "fog" "fog"
  Material "matte" "rgb Kd" [ .6 .55 .5 ]
  AttributeBegin
    Translate -0.6 1.4 0.5
    Rotate 30 1 0 0
    Shape "disk" "float radius" 0.2
    Translate 0.15 -0.5 0
    Shape "disk" "float radius" 0.2 "float innerradius" 0.1
  AttributeEnd
  AttributeBegin
    Translate 0.55 0.3 0.4
    Rotate -90 1 0 0
    Shape "cylinder" "float radius" 0.12 "float zmin" -0.2 "float zmax" 0.3
    Translate -0.3 0.4 0
    Shape "cone" "float radius" 0.15 "float height" 0.4
    Translate 0 -0.5 0.1
    Shape "paraboloid" "float radius" 0.15 "float zmax" 0.3
  AttributeEnd
  AttributeBegin
    Translate -0.5 0.4 -0.2
    Scale 0.2 0.2 0.3
    Shape "hyperboloid"
  AttributeEnd
  AttributeBegin
    Material "matte" "rgb Kd" [ .3 .5 .7 ]
    Shape "curve" "point P" [ -0.7 1.6 -0.3  -0.3 1.8 -0.2  0.2 1.5 -0.4  0.6 1.7 -0.3 ]
        "float width0" 0.04 "float width1" 0.01
    Shape "curve" "string type" "cylinder"
        "point P" [ -0.6 0.9 -0.5  -0.2 1.3 -0.4  0.2 0.7 -0.5  0.6 1.1 -0.4 ]
        "float width" 0.03
    Shape "curve" "string type" "ribbon"
        "point P" [ -0.6 0.5 -0.6  -0.2 0.7 -0.5  0.2 0.3 -0.6  0.6 0.6 -0.5 ]
        "normal N" [ 0 0 -1  0 1 -1 ] "float width" 0.05
  AttributeEnd
  AttributeBegin
    Material "matte" "rgb Kd" [ .7 .6 .2 ]
    Translate 0.1 1.1 0.6
    Scale 0.5 0.5 0.3
    Shape "nurbs" "integer nu" 3 "integer nv" 3 "integer uorder" 3
        "integer vorder" 3 "float uknots" [ 0 0 0 1 1 1 ]
        "float vknots" [ 0 0 0 1 1 1 ] "point P" [ 0 0 0  0.5 0 0.6  1 0 0
          0 0.5 0.4  0.5 0.5 -0.5  1 0.5 0.3  0 1 0  0.5 1 0.5  1 1 0 ]
        "float Pw" [ 1 2 1 1 0.5 1 1 2 1 ]
  AttributeEnd
  AttributeBegin
    Material "matte" "rgb Kd" [ .5 .5 .45 ]
    Translate -0.95 0.02 0.95
    Scale 1.9 1 1.9
    Rotate -90 1 0 0
    Shape "heightfield" "integer nu" {hf} "integer nv" {hf} "float Pz" [ {pz} ]
  AttributeEnd
{loop}AttributeEnd
WorldEnd
"""

# a regular icosahedron, for Loop subdivision
_ICO_T = (1.0 + 5 ** 0.5) / 2.0
ICOSAHEDRON_P = [(-1, _ICO_T, 0), (1, _ICO_T, 0), (-1, -_ICO_T, 0),
                 (1, -_ICO_T, 0), (0, -1, _ICO_T), (0, 1, _ICO_T),
                 (0, -1, -_ICO_T), (0, 1, -_ICO_T), (_ICO_T, 0, -1),
                 (_ICO_T, 0, 1), (-_ICO_T, 0, -1), (-_ICO_T, 0, 1)]
ICOSAHEDRON_F = [0, 11, 5, 0, 5, 1, 0, 1, 7, 0, 7, 10, 0, 10, 11, 1, 5, 9,
                 5, 11, 4, 11, 10, 2, 10, 7, 6, 7, 1, 8, 3, 9, 4, 3, 4, 2,
                 3, 2, 6, 3, 6, 8, 3, 8, 9, 4, 9, 5, 2, 4, 11, 6, 2, 10,
                 8, 6, 7, 9, 8, 1]


def shapes_fog_pbrt(size, iters=16, photons=65536, loop_levels=None, hf=64,
                    seed=36):
    """examples/cornell_fog.pbrt with one Shape of each kind in its fog: a
    disk, an annulus, a cylinder, a cone, a paraboloid, a hyperboloid, a
    curve of each type, a rational NURBS patch and an hf x hf heightfield
    of seeded heights (10,288 triangles at hf = 64); with ``loop_levels``,
    also a Loop-subdivided icosahedron (20 x 4^levels triangles)."""
    rs = np.random.RandomState(seed)
    pz = " ".join(f"{v:.5f}" for v in 0.12 * rs.rand(hf * hf))
    loop = ""
    if loop_levels is not None:
        pts = "  ".join(f"{x:.6f} {y:.6f} {z:.6f}" for x, y, z in
                        ICOSAHEDRON_P)
        loop = ("  AttributeBegin\n"
                '    Material "matte" "rgb Kd" [ .4 .6 .4 ]\n'
                "    Translate 0.35 0.75 0.1\n    Scale 0.16 0.16 0.16\n"
                '    Shape "loopsubdiv" "integer nlevels" '
                f'{loop_levels} "integer indices" '
                f'[ {" ".join(map(str, ICOSAHEDRON_F))} ] '
                f'"point P" [ {pts} ]\n  AttributeEnd\n')
    return (_FOG_BOX_HEAD.format(size=size, iters=iters, photons=photons)
            + _FOG_BOX_SHAPES.format(hf=hf, pz=pz, loop=loop))


# --- the cameras and the measured and fiber materials (ROADMAP Queue 1
# items 5.7-5.8) ---

ROOT = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))
# cornell_fog.pbrt's Camera line in place, and its replacements; the
# realistic camera's singlet (tests/test_realistic_camera.py) is written
# beside the scene by write_fiber_assets
CAMERAS = {
    "perspective": 'Camera "perspective" "float fov" 40',
    "orthographic": 'Camera "orthographic"',
    "environment": 'Camera "environment"',
    "thin_lens": ('Camera "perspective" "float fov" 40 '
                  '"float lensradius" 0.05 "float focaldistance" 3'),
    "realistic": ('Camera "realistic" "string lensfile" "singlet.dat" '
                  '"float aperturediameter" 12 "float focusdistance" 3.9'),
}
SINGLET_LENS = "# biconvex singlet\n50 5 1.5 30\n0 2 0 6\n-50 45 1 30\n"
# a hair curve, a Fourier sphere (fiber.bsdf), a subsurface and a
# kdsubsurface sphere in the fog, fog on both sides
HAIR_WORLD = """AttributeBegin
  MediumInterface "fog" "fog"
  Material "hair" "rgb color" [ .6 .4 .2 ] "float beta_m" 0.3
  Shape "curve" "string type" "cylinder" "float width" 0.06
      "point P" [ -0.7 0.2 0.2  -0.3 1.4 -0.2  0.3 0.4 0.3  0.7 1.6 0.0 ]
AttributeEnd
"""
FOURIER_WORLD = """AttributeBegin
  MediumInterface "fog" "fog"
  Translate 0.1 1.3 0.5
  Material "fourier" "string bsdffile" "fiber.bsdf"
  Shape "sphere" "float radius" 0.28
AttributeEnd
"""
SSS_WORLD = """AttributeBegin
  MediumInterface "fog" "fog"
  Translate -0.45 0.35 -0.2
  Material "subsurface" "string name" "Skin1" "float scale" 20
  Shape "sphere" "float radius" 0.3
  Translate 0.9 0 0
  Material "kdsubsurface" "rgb Kd" [ .7 .5 .3 ] "rgb mfp" [ .05 .05 .05 ]
  Shape "sphere" "float radius" 0.3
AttributeEnd
"""
FIBER_WORLD = HAIR_WORLD + FOURIER_WORLD + SSS_WORLD


def write_fiber_assets(directory):
    """The singlet lens file and a three-channel Fourier table
    (glossy_fourier_table) written into ``directory``."""
    import os

    from bre_tpu_torch.fourier import write_bsdf_file

    with open(os.path.join(directory, "singlet.dat"), "w") as f:
        f.write(SINGLET_LENS)
    write_bsdf_file(os.path.join(directory, "fiber.bsdf"),
                    glossy_fourier_table())


def cornell_fog_text(camera="perspective", size=None, iters=None,
                     photons=None, world="", integrator=None):
    """examples/cornell_fog.pbrt with its Camera line replaced by
    CAMERAS[camera], optionally its resolution, iterations and photons,
    ``world`` statements added before WorldEnd, and its Integrator block
    replaced by ``integrator``."""
    import os
    import re

    text = open(os.path.join(ROOT, "examples", "cornell_fog.pbrt")).read()
    text = text.replace(CAMERAS["perspective"], CAMERAS[camera])
    if size is not None:
        text = re.sub(r'"integer ([xy])resolution" \[ \d+ \]',
                      rf'"integer \1resolution" [ {size} ]', text)
    if iters is not None:
        text = re.sub(r'"integer iterations" \[ \d+ \]',
                      f'"integer iterations" [ {iters} ]', text)
    if photons is not None:
        text = re.sub(r'"integer photonsperiteration" \[ \d+ \]',
                      f'"integer photonsperiteration" [ {photons} ]', text)
    if integrator is not None:
        text = re.sub(r'Integrator "photonbeam"(\n    "[^\n]*)*',
                      integrator, text, count=1)
    return text.replace("WorldEnd", world + "WorldEnd")
