"""imgtool: image utilities (diff / cat / convert / assemble / makesky), the
same subcommands, flags, printed text and exit codes as
``bre_tpu/tools/imgtool.py``.

pbrt's imgtool.cpp: ``assemble`` (:190), ``cat`` (:287), ``diff`` with MSE
(:334), convert and tonemap, makesky (:87-188).  ``diff``, ``convert``,
``assemble`` and ``makesky`` do their array work in torch on ``--device``
("cuda" unless the caller asks for the CPU), in the reference's dtypes:
float64 for diff and assemble, float32 for convert.  ``cat`` only prints
pixels and takes no device.
Usage: ``python -m bre_tpu_torch.tools.imgtool diff a.pfm b.pfm [--tol 0.01]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..io.image import read_image, write_image
from ..scene.scene import resolve_device


def _read(path, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(read_image(path), device=dev).to(dtype)


def _write(path, img: torch.Tensor) -> None:
    write_image(path, img.to(torch.float32).cpu().numpy())


def cmd_diff(args) -> int:
    """MSE/MRSE diff (imgtool.cpp:334-417)."""
    dev = resolve_device(args.device)
    a = _read(args.image1, torch.float64, dev)
    b = _read(args.image2, torch.float64, dev)
    if a.shape != b.shape:
        print(f"imgtool: size mismatch {tuple(a.shape)} vs {tuple(b.shape)}",
              file=sys.stderr)
        return 1
    diff = a - b
    mse = float((diff * diff).mean())
    mrse = float(((diff * diff) / torch.clamp_min(b * b, 1e-10)).mean())
    avg_a, avg_b = float(a.mean()), float(b.mean())
    delta = 100.0 * (avg_a - avg_b) / avg_b if avg_b != 0 else float("inf")
    n_diff = int((diff != 0).sum())
    print(
        f"imgtool: {n_diff} pixels differ ({100.0 * n_diff / diff.numel():.2f}%)\n"
        f"  avg {avg_a:.6g} vs {avg_b:.6g} (delta {delta:+.3f}%)\n"
        f"  MSE {mse:.6g}, MRSE {mrse:.6g}"
    )
    if args.outfile:
        _write(args.outfile, torch.abs(diff))
    if args.tol is not None:
        return 1 if mse > args.tol else 0
    # no tolerance: exit 1 on ANY difference (imgtool.cpp diff semantics)
    return 1 if n_diff > 0 else 0


def cmd_cat(args) -> int:
    """Print pixel values (imgtool.cpp:287-332)."""
    img = read_image(args.image)
    h, w = img.shape[:2]
    print(f"{args.image}: {w} x {h}")
    for y in range(h):
        for x in range(w):
            px = img[y, x]
            print(f"({x}, {y}): ({px[0]:.6g}, {px[1]:.6g}, {px[2]:.6g})")
    return 0


def _box_same(v: torch.Tensor, w: int, k: float, axis: int) -> torch.Tensor:
    """np.convolve(v, ones(2w+1)/(2w+1), mode="same") along ``axis`` of a
    float32 (H, W, 3) image, zero padded: the 2w+1 shifted copies, each
    times the kernel's float32 tap, summed in a fixed order.  Plain
    elementwise work gives the same bits on the CPU and the card (a cuDNN
    convolution would pick its own algorithm, and TF32, there)."""
    n = v.shape[axis]
    pad = [0] * (2 * v.dim())
    pad[2 * (v.dim() - 1 - axis)] = pad[2 * (v.dim() - 1 - axis) + 1] = w
    p = torch.nn.functional.pad(v, pad)
    out = torch.zeros_like(v)
    for j in range(2 * w + 1):
        out = out + p.narrow(axis, j, n) * k
    return out


def cmd_convert(args) -> int:
    """Convert between formats with the reference's post-ops
    (imgtool.cpp convert: -scale, -tonemap/-maxluminance, -bloom*,
    -repeatpix, -flipy)."""
    dev = resolve_device(args.device)
    img = _read(args.infile, torch.float32, dev)
    img = img * args.scale

    if args.bloomlevel < float("inf"):
        # imgtool.cpp:~430-470: pixels above bloomlevel are blurred
        # (bloomiters box passes of half-width bloomwidth) and blended in
        bloom = torch.where(img.amax(-1, keepdim=True) > args.bloomlevel,
                            img, 0.0)
        w = max(1, int(args.bloomwidth))
        k = float(np.float32(1.0) / np.float32(2 * w + 1))
        for _ in range(max(1, args.bloomiters)):
            for ax in (0, 1):
                bloom = _box_same(bloom, w, k, ax)
        img = img + args.bloomscale * bloom

    if args.tonemap:
        # imgtool.cpp tonemap: scale by maxluminance then Reinhard-style
        img = img / max(args.maxluminance, 1e-9)
        img = img / (1.0 + img)
    if args.repeatpix > 1:
        img = img.repeat_interleave(args.repeatpix, 0).repeat_interleave(
            args.repeatpix, 1)
    if args.flipy:
        img = img.flip(0)
    _write(args.outfile, img)
    print(f"imgtool: wrote {args.outfile}")
    return 0


def cmd_assemble(args) -> int:
    """Merge non-overlapping crops into one image (imgtool.cpp:190-285).

    Crops are full-size images that are zero outside their window; assemble
    sums them (the film writes full frames, so this is a sum-merge).
    """
    dev = resolve_device(args.device)
    imgs = [_read(f, torch.float64, dev) for f in args.images]
    base = torch.zeros_like(imgs[0])
    for im in imgs:
        if im.shape != base.shape:
            print("imgtool: size mismatch in assemble", file=sys.stderr)
            return 1
        base = base + im
    _write(args.outfile, base)
    print(f"imgtool: wrote {args.outfile}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="imgtool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_flag(p):
        p.add_argument("--device", default="cuda",
                       help='torch device of the array work (default "cuda";'
                            ' "cpu" to run on the CPU)')

    d = sub.add_parser("diff")
    d.add_argument("image1")
    d.add_argument("image2")
    d.add_argument("--outfile", "-o", default=None)
    d.add_argument("--tol", type=float, default=None,
                   help="exit 1 if MSE exceeds this")
    device_flag(d)
    c = sub.add_parser("cat")
    c.add_argument("image")
    v = sub.add_parser("convert")
    v.add_argument("infile")
    v.add_argument("outfile")
    v.add_argument("--scale", type=float, default=1.0)
    v.add_argument("--tonemap", action="store_true")
    v.add_argument("--maxluminance", type=float, default=1.0,
                   help="luminance mapped to white by --tonemap")
    v.add_argument("--bloomlevel", type=float, default=float("inf"),
                   help="pixels above this bloom (imgtool convert -bloomlevel)")
    v.add_argument("--bloomwidth", type=int, default=15)
    v.add_argument("--bloomscale", type=float, default=0.3)
    v.add_argument("--bloomiters", type=int, default=5)
    v.add_argument("--repeatpix", type=int, default=1,
                   help="replicate each pixel NxN")
    v.add_argument("--flipy", action="store_true")
    device_flag(v)
    a = sub.add_parser("assemble")
    a.add_argument("outfile")
    a.add_argument("images", nargs="+")
    device_flag(a)
    s = sub.add_parser("makesky", help="analytic daylight sky map "
                       "(Hosek-Wilkie; reference imgtool.cpp:87-188)")
    s.add_argument("--outfile", "-o", default="sky.pfm")
    s.add_argument("--resolution", type=int, default=512)
    s.add_argument("--elevation", type=float, default=30.0,
                   help="sun elevation above the horizon, degrees")
    s.add_argument("--turbidity", type=float, default=3.0)
    s.add_argument("--albedo", type=float, default=0.5,
                   help="ground albedo in [0,1] (Hosek model only)")
    s.add_argument("--model", choices=["hosek", "preetham"],
                   default="hosek",
                   help="hosek = reference ArHosekSkyModel behavior; "
                        "preetham = closed-form fallback, no data tables")
    s.add_argument("--layout", choices=["equalarea", "equirect"],
                   default="equalarea")
    device_flag(s)
    args = ap.parse_args(argv)
    if args.cmd == "makesky":
        from .sky import cmd_makesky

        return cmd_makesky(args)
    return {"diff": cmd_diff, "cat": cmd_cat, "convert": cmd_convert,
            "assemble": cmd_assemble}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
