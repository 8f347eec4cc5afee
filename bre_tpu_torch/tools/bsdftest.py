"""bsdftest: BSDF sampling-consistency checker, the same estimators, printed
table and exit code as ``bre_tpu/tools/bsdftest.py``.

pbrt's src/tools/bsdftest.cpp estimates each BSDF's hemispherical
reflectance two ways (importance sampling via Sample_f and uniform-direction
sampling via f); a large disagreement flags a broken Sample_f/Pdf pair.
Three estimators per material at one oblique wo:
  rho_is  = E[f(wo, wi) |cos| / pdf(wi)],  wi ~ Sample_f
  rho_uni = E[f(wo, wi) |cos| * 2 pi],     wi ~ uniform hemisphere
  pdf_int = E[pdf(wo, wi) * 2 pi]          (<= 1; == 1 when the sampler
                                            covers the hemisphere)
Exit code 1 if any material disagrees by more than --tol.

The two random streams are the reference's: PCG32 for the sampled u's and
``np.random.RandomState(seed)`` for the uniform directions, so the figures
compare with the reference's.  ``sample_bsdf``/``eval_bsdf`` run on
``--device`` ("cuda" unless the caller asks for the CPU); the means are
taken on the host with numpy, as the reference takes them.
Usage: ``python -m bre_tpu_torch.tools.bsdftest --device cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.rng import pcg32_init, pcg32_next_f32
from ..materials import MODE_RADIANCE, eval_bsdf, sample_bsdf
from ..scene.builder import SceneBuilder
from ..scene.scene import resolve_device


def _make_material(builder: SceneBuilder, name: str) -> int:
    mk = {
        "matte": lambda: builder.matte(kd=(0.6, 0.5, 0.4)),
        "plastic": lambda: builder.plastic(kd=(0.4,) * 3, ks=(0.3,) * 3,
                                           roughness=0.2),
        "uber": lambda: builder.uber(),
        "metal": lambda: builder.metal(roughness=0.2),
        "substrate": lambda: builder.substrate(roughness=0.15),
        "translucent": lambda: builder.translucent(),
    }
    return mk[name]()


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def test_material(name: str, n: int = 65536, seed: int = 0, device="cuda"):
    """The three estimates of one material at n lanes: {name, rho_is,
    rho_uni, pdf_integral, specular}."""
    dev = resolve_device(device)
    b = SceneBuilder()
    mi = _make_material(b, name)
    mats = b.build(device=dev).materials

    rs = np.random.RandomState(seed)
    R = n
    # fixed oblique wo
    wo = torch.as_tensor(np.tile([0.3, 0.2, 0.933], (R, 1))
                         / np.linalg.norm([0.3, 0.2, 0.933]),
                         dtype=torch.float32, device=dev)
    nrm = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(R, 3)
    mat = torch.full((R,), mi, dtype=torch.int64, device=dev)

    # importance-sampled estimate
    rng = pcg32_init(torch.arange(R, dtype=torch.int64, device=dev)
                     + seed * 7919)
    rng, u0 = pcg32_next_f32(rng)
    rng, u1 = pcg32_next_f32(rng)
    bs = sample_bsdf(mats, mat, nrm, wo, torch.stack([u0, u1], -1),
                     mode=MODE_RADIANCE)
    pdf = _np(bs.pdf)
    ok = _np(bs.valid) & (pdf > 1e-9)
    cos_i = np.abs(_np(bs.wi)[:, 2])
    rho_is = np.where(ok, _np(bs.f)[:, 0] * cos_i
                      / np.maximum(pdf, 1e-12), 0.0).mean()

    # uniform-hemisphere estimate of the same integral (specular lobes have
    # measure zero under uniform sampling; skip for them)
    specular = bool(_np(bs.specular).any())
    zs = rs.uniform(0, 1, R)
    phis = rs.uniform(0, 2 * np.pi, R)
    sin_t = np.sqrt(1 - zs ** 2)
    wi_u = torch.as_tensor(np.stack([sin_t * np.cos(phis),
                                     sin_t * np.sin(phis), zs], -1),
                           dtype=torch.float32, device=dev)
    f_u, pdf_u = eval_bsdf(mats, mat, nrm, wo, wi_u)
    rho_uni = float((_np(f_u)[:, 0] * zs * 2 * np.pi).mean())
    pdf_int = float((_np(pdf_u) * 2 * np.pi).mean())
    return dict(name=name, rho_is=float(rho_is), rho_uni=rho_uni,
                pdf_integral=pdf_int, specular=specular)


test_material.__test__ = False  # a tool, not a pytest test


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bsdftest")
    ap.add_argument("--materials", nargs="+",
                    default=["matte", "plastic", "metal", "substrate"])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--tol", type=float, default=0.08)
    ap.add_argument("--device", default="cuda",
                    help='torch device of the BSDF evaluations (default '
                         '"cuda"; "cpu" to run on the CPU)')
    args = ap.parse_args(argv)
    bad = 0
    print(f"{'material':<12} {'rho(IS)':>9} {'rho(uni)':>9} "
          f"{'pdf-int':>8}  status")
    for name in args.materials:
        r = test_material(name, args.n, device=args.device)
        if r["specular"]:
            status = "specular (uniform estimate skipped)"
            rel = 0.0
        else:
            rel = abs(r["rho_is"] - r["rho_uni"]) / max(r["rho_uni"], 1e-6)
            status = "OK" if rel < args.tol else f"MISMATCH ({rel:.1%})"
            if rel >= args.tol:
                bad += 1
        print(f"{r['name']:<12} {r['rho_is']:>9.4f} {r['rho_uni']:>9.4f} "
              f"{r['pdf_integral']:>8.4f}  {status}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
