"""Profile one forward+backward iteration of the port on a CUDA card.

Run from the repository root:  python3 profile_step.py

The iteration is bench.py's spec-scale step: its fog box at 256x256, 1,000,000
photons, maxdepth 5, radius 0.1, gather="auto", grad_extras=False, mean(Ld)
differentiated in sigma_a and sigma_s (chip_smoke.py's phase 9).  Prints the
card, the s/step of a warm step (synchronized host clock) and the
torch.profiler table of one step by device time.
"""

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as S


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_step.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    S.card_info(dev)
    S.cuda_build.load_library()
    scene, cam = S.fog_box(dev, S.SPEC_WH)
    cfg = S.PB.PhotonBeamConfig(
        maxdepth=S.MAXDEPTH, photonsperiteration=S.SPEC_PHOTONS,
        initialbeamradius=0.1, gather="auto", grad_geometry=False,
        grad_extras=False)
    S.timed_step(scene, cam, S.SPEC_WH, cfg, 0)
    t, loss, _ = S.timed_step(scene, cam, S.SPEC_WH, cfg, 1)
    print(f"{t:.4f} s/step, value {loss:.7e}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        S.timed_step(scene, cam, S.SPEC_WH, cfg, 1)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=20, max_name_column_width=60))


if __name__ == "__main__":
    main()
