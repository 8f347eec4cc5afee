"""Time the two-pass backward (Queue 2 row 6, ``gather_backward_twopass``)
of several source trees in turns, on the same captured sweeps, on one CUDA
card, beside the dense backward (row 3) on the same inputs.

Run from the repository root (not a test; needs a card and nvcc):
  python3 tests/torch_twopass_ab.py NAME=ROOT ...
Each ROOT is a checkout (or ``git archive`` of one) holding
``bre_tpu_torch/ops`` and ``bre_tpu_torch/csrc`` (e.g.
``parent=.scratch/parent new=.``); each tree's ops are imported as a
package of its own, so all libraries live in one process.

The sweeps are ``chip_smoke.py``'s: phase 22's first in-medium gather (the
geometry-attached step's, at 128x128 / 50k photons, packed by the
non-packed route) and the spec step's R/4 and full-film backward sweeps
(256x256 / 1M photons).  Each tree's kernel is timed with CUDA events (mean
of 3 calls after a warm-up) in the order of the trees, then again in
reverse; every tree's d_beams must equal the first tree's bit for bit and
its d_rays must agree with it per cotangent within 2e-4 of max|first|
(the split sweep adds each tile's chunks in other groups).  Row 3
(``gather_backward_fused``, all-ones mask, extras on) of the last tree is
timed on the same inputs.  Each tree's kernels, and row 3's, are then
timed apart under torch.profiler (device ms per kernel name, mean of 3
calls).  Prints one JSON line and writes it to
``chiprun_out/twopass_ab.json``.
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from torch_sparse_ab import load_tree  # noqa: E402
from bre_tpu_torch.accel import beam_gather as BG  # noqa: E402
from bre_tpu_torch.integrators import photonbeam as PB  # noqa: E402
from bre_tpu_torch.ops import gather_bwd as GB  # noqa: E402

REPS = 3


def gather22(dev):
    """Phase 22's first in-medium gather, packed as the non-packed route
    packs it for the two-pass backward: (rays, beams, scalars, ct)."""
    scene, cam = CS.fog_box(dev, CS.BENCH_WH)
    cfg = PB.PhotonBeamConfig(maxdepth=CS.MAXDEPTH,
                              photonsperiteration=CS.BENCH_PHOTONS,
                              initialbeamradius=0.2)
    rec, orig = [], PB.gather_beams_bruteforce

    def first_gather(*a, **k):
        if not rec:
            rec.append(CS._detached_gather_args(a, k))
        return orig(*a, **k)
    PB.gather_beams_bruteforce = first_gather
    try:
        CS.timed_step(scene, cam, CS.BENCH_WH, cfg, 0)
    finally:
        PB.gather_beams_bruteforce = orig
    gather_args, kw = rec[0]
    W = torch.from_numpy(np.random.RandomState(23).uniform(
        0, 1, (gather_args[2].shape[0], 3)).astype(np.float32)).to(dev)
    packed, orig_tp = [], BG.gather_backward_twopass

    def record(*a):
        packed.append(a)
        return orig_tp(*a)
    saved = (BG.PALLAS_BWD_ENABLED, BG.PALLAS_BWD_MODE)
    BG.gather_backward_twopass = record
    try:
        CS._analytic_run(gather_args, kw, True, "twopass", W)
    finally:
        BG.gather_backward_twopass = orig_tp
        BG.PALLAS_BWD_ENABLED, BG.PALLAS_BWD_MODE = saved
    return packed[0]


def sweeps(dev):
    """{label: (rays, beams, scalars, ct_packed)}."""
    out = {"phase 22 gather": gather22(dev)}
    scene, cam = CS.fog_box(dev, CS.SPEC_WH)
    cfg = PB.PhotonBeamConfig(
        maxdepth=CS.MAXDEPTH, photonsperiteration=CS.SPEC_PHOTONS,
        initialbeamradius=0.1, gather="auto", grad_geometry=False,
        grad_extras=False)
    _, rec = CS.capture_backward(
        lambda: CS.timed_step(scene, cam, CS.SPEC_WH, cfg, 0))
    labels = {CS.SPEC_WH ** 2 // BG.TILE: "spec full",
              CS.SPEC_WH ** 2 // 4 // BG.TILE: "spec r4"}
    for beams, rays, scal, _, ct, _, _ in rec:
        label = labels.get(rays.shape[0])
        if label and label not in out:
            out[label] = (rays, beams, scal, BG.pack_ct(ct, rays.shape[0]))
    return out


def check_same(out, ref, what):
    """d_beams bit for bit; d_rays per cotangent within 2e-4 max|ref|."""
    if not torch.equal(out[1], ref[1]):
        raise AssertionError(f"{what}: d_beams differ")
    for name, sl in GB.D_RAYS_ROWS.items():
        err = float((out[0][:, sl] - ref[0][:, sl]).abs().max())
        r_max = float(ref[0][:, sl].abs().max())
        if not err <= 2e-4 * (r_max + 1e-9):
            raise AssertionError(f"{what}: d {name} {err} of {r_max}")


def kernel_split(calls):
    """{label: {kernel name: device ms per call}} from one torch.profiler
    run; each call runs in a range of its own that ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with record_function(f"ab|{label}"):
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ab|")]
    out = {}
    for e in events:
        if not e.name.startswith("ab|"):
            continue
        s, t = e.time_range.start, e.time_range.end
        per = {}
        for a, b, k in kernels:
            if s <= a and b <= t:
                k = k.replace("(anonymous namespace)::", "").replace(
                    "void ", "").split("(")[0]
                per[k] = per.get(k, 0.0) + (b - a) / 1e3 / REPS
        out[e.name[3:]] = per
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_twopass_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = CS.card_info(dev)
    specs = dict(a.split("=", 1) for a in sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        trees = {n: load_tree(n, s, tmp, ("twopass", "power", "extent",
                                          "_dense"))[1]
                 for n, s in specs.items()}
        cases = sweeps(dev)
        names = list(trees)
        times = {label: {n: [] for n in names + ["row 3"]} for label in cases}
        info = {}
        for label, args in cases.items():
            rays, beams, scal, ct = args
            flags, extent = GB.twopass_chunk_flags(beams)
            info[label] = dict(n_tiles=rays.shape[0], n_chunks=beams.shape[0],
                               flagged=int(flags.sum()), extent=int(extent),
                               n_valid=float(scal[0, 3]))
            ref = None
            for n in names + names[::-1]:
                fn = lambda gb=trees[n]: gb.gather_backward_twopass(*args)  # noqa: E731
                out = fn()
                if ref is None:
                    ref = out
                else:
                    check_same(out, ref, f"{n} against {names[0]} on {label}")
                ms, _ = CS.cuda_ms(fn, REPS, warm=False)
                times[label][n].append(ms)
                info[label][f"{n} grid"] = trees[n].gather_backward_twopass.last_grid
            ones = torch.ones((beams.shape[0], rays.shape[0]), device=dev)
            gb = trees[names[-1]]
            for _ in range(2):
                ms, _ = CS.cuda_ms(lambda: gb.gather_backward_fused(
                    rays, beams, scal, ct, ones, True), REPS)
                times[label]["row 3"].append(ms)
            del ref, out
            print(f"[ab] {label} {json.dumps(info[label])}: " + json.dumps(
                {n: [round(t, 3) for t in v] for n, v in
                 times[label].items()}), flush=True)
        calls = {}
        for label, args in cases.items():
            for n in names:
                calls[f"{label}|{n}"] = (
                    lambda gb=trees[n], a=args: gb.gather_backward_twopass(*a))
            rays, beams, scal, ct = args
            ones = torch.ones((beams.shape[0], rays.shape[0]), device=dev)
            calls[f"{label}|row 3"] = (
                lambda gb=trees[names[-1]], a=(*args, ones, True):
                gb.gather_backward_fused(*a))
        split = kernel_split(calls)
        for label, per in split.items():
            print(f"[ab] {label} device ms per kernel: "
                  + json.dumps({k: round(v, 3) for k, v in per.items()}),
                  flush=True)
    res = dict(card=card, specs=specs, sweeps=info, ms=times,
               kernels_ms=split,
               mean_ms={label: {n: float(np.mean(v)) for n, v in t.items()}
                        for label, t in times.items()})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "twopass_ab.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res["mean_ms"]))


if __name__ == "__main__":
    main()
