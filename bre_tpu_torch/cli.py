"""Command-line renderer: ``python -m bre_tpu_torch.cli scene.pbrt``
(counterpart of ``bre_tpu/cli.py``).

pbrt's src/main/pbrt.cpp:74-162: flags --outfile, --quick, --quiet,
--nthreads (accepted for compatibility), --cat (the reformatted scene on
stdout) and --toply (the same, with large triangle meshes written to .ply
files; scene/cat.py), --device (where the render runs: "cuda" unless the
caller asks for the CPU) and --kernel (the photon-beam estimator: "bre",
or "compat" for the reference renderer's own).  The flow is pbrtInit ->
ParseFile -> render -> write (api.cpp:1361-1417).  The photon-beam
integrator is the one the port renders; the reference's other integrators
print that they are not ported and return 1.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from .integrators.photonbeam import PhotonBeamConfig, render_photonbeam
from .io.image import write_image
from .scene.cat import cat_scene
from .scene.parser import ParsedScene, parse_file

# integrators bre_tpu/cli.py renders that the port does not
_NOT_PORTED = ("vsppm", "volpath", "path", "whitted", "directlighting",
               "bdpt", "mlt")


def photonbeam_config(ps: ParsedScene, quick: bool = False,
                      kernel: Optional[str] = None) -> PhotonBeamConfig:
    """The PhotonBeamConfig of a parsed scene's Integrator line, as
    bre_tpu/cli.py:99-115 builds it; ``quick`` divides the iterations by
    16 (pbrt --quick)."""
    p = ps.integrator_params

    def geti(key, default):
        v = p.get(key, default)
        return int(v[0] if isinstance(v, list) else v)

    def getf(key, default):
        v = p.get(key, default)
        return float(v[0] if isinstance(v, list) else v)

    iters = max(1, geti("iterations", geti("numiterations", 64))
                // (16 if quick else 1))
    return PhotonBeamConfig(
        iterations=iters,
        startiteration=geti("startiteration", 0),
        enditeration=geti("enditeration", iters),
        maxdepth=geti("maxdepth", 5),
        photonsperiteration=geti("photonsperiteration", -1),
        imagewritefrequency=geti("imagewritefrequency", 1 << 31),
        initialbeamradius=getf("initialbeamradius", 1.0),
        alpha=getf("alpha", 0.5),
        rendersurfaces=bool(p.get("rendersurfaces", True)),
        rendermedia=bool(p.get("rendermedia", True)),
        kernel=kernel or "bre",
    )


def apply_film(img: np.ndarray, ps: ParsedScene) -> np.ndarray:
    """Film post-ops (film.cpp): the crop window keeps pixels
    [ceil(res * c0), ceil(res * c1)) on each axis (film.cpp:~60), and the
    scale multiplies the written values (film.cpp WriteImage)."""
    if ps.crop is not None:
        x0, x1, y0, y1 = ps.crop
        px0 = int(np.ceil(ps.width * x0))
        px1 = int(np.ceil(ps.width * x1))
        py0 = int(np.ceil(ps.height * y0))
        py1 = int(np.ceil(ps.height * y1))
        img = img[py0:py1, px0:px1]
    if ps.film_scale != 1.0:
        img = img * np.float32(ps.film_scale)
    return img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bre_tpu_torch",
        description="volumetric photon-beam renderer on PyTorch and CUDA "
                    "(pbrt-compatible scenes)",
    )
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--outfile", "-o", default=None, help="override output image path")
    ap.add_argument("--quick", action="store_true",
                    help="reduce iteration counts 16x (pbrt --quick)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--nthreads", type=int, default=0,
                    help="accepted for pbrt compatibility (no effect)")
    ap.add_argument("--kernel", default=None, choices=["bre", "compat"],
                    help="photonbeam estimator kernel: 'bre' (physically "
                         "normalized, default) or 'compat' (the reference "
                         "renderer's unnormalized 1e-5 kernel and splitting "
                         "photon walk, for image matching)")
    ap.add_argument("--cat", action="store_true",
                    help="print reformatted scene to stdout and exit (pbrt --cat)")
    ap.add_argument("--toply", action="store_true",
                    help="like --cat, converting large triangle meshes to PLY "
                         "files next to the scene (pbrt --toply)")
    ap.add_argument("--device", default="cuda",
                    help='torch device to render on (default "cuda"; "cpu" '
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.cat or args.toply:
        scene_path = Path(args.scene)
        try:
            text = scene_path.read_text()
        except FileNotFoundError:
            print(f"error: scene file not found: {args.scene}", file=sys.stderr)
            return 1
        sys.stdout.write(cat_scene(
            text, include_dir=scene_path.parent,
            toply_dir=scene_path.parent if args.toply else None,
        ))
        return 0

    t0 = time.time()
    try:
        ps = parse_file(args.scene, device=args.device)
    except FileNotFoundError:
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 1
    scene = ps.build(device=args.device)
    if ps.camera is None:
        print("error: scene has no Camera directive", file=sys.stderr)
        return 1
    if not args.quiet:
        print(
            f"bre_tpu_torch: parsed {args.scene}: {scene.n_spheres} spheres, "
            f"{scene.n_triangles} triangles, {scene.n_lights} lights, "
            f"{scene.n_media} media; integrator={ps.integrator_name} "
            f"{ps.width}x{ps.height}"
        )

    name = ps.integrator_name
    if name in _NOT_PORTED:
        print(f"error: integrator '{name}' is not ported (ROADMAP Queue 1 "
              "item 4)", file=sys.stderr)
        return 1
    if name != "photonbeam":
        print(f"error: integrator '{name}' not supported yet", file=sys.stderr)
        return 1
    cfg = photonbeam_config(ps, quick=args.quick, kernel=args.kernel)
    img, stats = render_photonbeam(scene, ps.camera, ps.width, ps.height, cfg)

    img = apply_film(img.cpu().numpy(), ps)
    out = args.outfile or ps.filename
    write_image(out, img)
    if not args.quiet:
        dt = time.time() - t0
        print(f"bre_tpu_torch: wrote {out} ({dt:.1f}s)")
        for k, v in (stats or {}).items():
            print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
