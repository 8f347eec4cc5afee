"""Profile one forward+backward iteration of the port on a CUDA card.

Run from the repository root:  python3 profile_step.py [--hetero | --attached]

The iteration is bench.py's spec-scale step: its fog box at 256x256, 1,000,000
photons, maxdepth 5, radius 0.1, gather="auto", grad_extras=False, mean(Ld)
differentiated in sigma_a and sigma_s (chip_smoke.py's phase 9).  With
``--hetero`` it is the config-3 step instead: examples/smoke_hetero.py's
grid smoke at 512x512, 100,000 photons, maxdepth 5, radius 0.15,
gather="pallas", mean(Ld) differentiated in the density grid and sigma_s
(chip_smoke.py's phase 16).  With ``--attached`` it is the default
config's step: bench.py's fog box at 128x128, 50,000 photons, radius 0.2,
the photon walk and the gather geometry attached (the non-packed route and
its recompute backward), mean(Ld) differentiated in sigma_a and sigma_s
(chip_smoke.py's phase 22).  Prints the card, the s/step of a warm step
(synchronized host clock) and the torch.profiler table of one step by
device time.
"""

import argparse

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as S


def main():
    ap = argparse.ArgumentParser()
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--hetero", action="store_true",
                       help="profile the config-3 step in (density, sigma_s)")
    which.add_argument("--attached", action="store_true",
                       help="profile the default config's geometry-attached "
                            "step at 128x128 x 50k")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    S.card_info(dev)
    S.cuda_build.load_library()
    if args.hetero:
        wh = S.SMOKE_SIZE
        scene, cam = S.smoke_scene(dev), S.smoke_camera(dev, wh)
        cfg = S.smoke_cfg(S.SMOKE_PHOTONS)
        step = S.timed_smoke_step
    elif args.attached:
        wh = S.BENCH_WH
        scene, cam = S.fog_box(dev, wh)
        cfg = S.PB.PhotonBeamConfig(maxdepth=S.MAXDEPTH,
                                    photonsperiteration=S.BENCH_PHOTONS,
                                    initialbeamradius=0.2)
        step = S.timed_step
    else:
        wh = S.SPEC_WH
        scene, cam = S.fog_box(dev, wh)
        cfg = S.PB.PhotonBeamConfig(
            maxdepth=S.MAXDEPTH, photonsperiteration=S.SPEC_PHOTONS,
            initialbeamradius=0.1, gather="auto", grad_geometry=False,
            grad_extras=False)
        step = S.timed_step
    step(scene, cam, wh, cfg, 0)
    t, loss, _ = step(scene, cam, wh, cfg, 1)
    print(f"{t:.4f} s/step, value {loss:.7e}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(scene, cam, wh, cfg, 1)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25, max_name_column_width=60))


if __name__ == "__main__":
    main()
