"""Time the sparse gather kernels (Queue 2 rows 2 and 4) of several source
trees in turns, on the same captured sweeps, on one CUDA card.

Run from the repository root (not a test; needs a card and nvcc):
  python3 tests/torch_sparse_ab.py NAME=ROOT ...
Each ROOT is a checkout (or ``git archive`` of one) holding
``bre_tpu_torch/ops`` and ``bre_tpu_torch/csrc``, built with its own
nvcc flags (e.g. ``parent=.scratch/parent new=.``).  Every tree's ops are
imported as a package of its own, so all libraries live in one process.

The sweeps come from this tree's ``chip_smoke.py`` helpers: the sparse
regime's config-2 full-film sweep (phase 33's point), config 2's full-film
sweep at iteration 2 with its own mask (the cap-at-grid sweep of phase 6),
config 3's full-film and 1-tile sweeps at iteration 2 (the hetero
instance, phase 15's sweeps; phase 14's counted run lists them at the
grid) and the spec step's R/4 and full-film backward sweeps (phase 11's).
Each kernel is timed with CUDA events (mean of 3 calls after a warm-up,
more for a call under 10 ms) in the order of the trees, then again in
reverse, and every tree's outputs must equal the first tree's bit for
bit.  So is each tree's build of the two id lists (``sparse_block_ids``,
``sparse_block_ids_chunk_major``) on the forward sweeps' masks, at the cap
that lists the whole grid and at gather="auto"'s default cap: its time
counts whatever host sync the build makes.  The cases under 5 ms are
split into device time and launches under torch.profiler.  Prints one
JSON line and writes it to ``chiprun_out/sparse_ab.json``.
"""

import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from bre_tpu_torch.accel import beam_gather as BG  # noqa: E402
from bre_tpu_torch.integrators import photonbeam as PB  # noqa: E402
from bre_tpu_torch.ops import gather as G  # noqa: E402
from bre_tpu_torch.ops import gather_bwd as GB  # noqa: E402


def load_tree(name, root, tmp, show=("sparse",)):
    """Import ROOT's ops as package ``ab_<name>`` with its own library;
    prints ptxas's report of the kernels whose names hold a word of
    ``show``."""
    pkg = os.path.join(tmp, name, f"ab_{name}")
    for part in ("ops", "csrc"):
        shutil.copytree(os.path.join(root, "bre_tpu_torch", part),
                        os.path.join(pkg, part))
    open(os.path.join(pkg, "__init__.py"), "w").close()
    sys.path.insert(0, os.path.join(tmp, name))
    build = importlib.import_module(f"ab_{name}.ops.cuda_build")
    t0 = time.perf_counter()
    build.load_library()
    print(f"[ab] {name}: built {root} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for kernel, use in CS.ptxas_summary(build.build_log or "").items():
        if any(w in kernel for w in show):
            print(f"[ab] {name} ptxas {kernel}: {use}", flush=True)
    return (importlib.import_module(f"ab_{name}.ops.gather"),
            importlib.import_module(f"ab_{name}.ops.gather_bwd"))


def sweeps(dev):
    """{label: (kind, inputs)}: kind "fwd" takes (rays, beams, scal, mask),
    "bwd" (rays, beams, scal, ct_packed, mask, want_extras), "lists"
    (mask, cap)."""
    out = {}
    _, point, _ = CS.regime_point(dev)
    rays, beams, scal, mask = point
    gen = torch.Generator(device="cpu").manual_seed(CS.REGIME_SEED)
    ct = torch.rand((rays.shape[0], GB.NDR, BG.TILE), generator=gen) * 2 - 1
    ct[:, 3:] = 0.0
    ct = ct.to(dev)
    out["regime fwd"] = ("fwd", (rays, beams, scal, mask))
    for e in (False, True):
        out[f"regime bwd extras={e}"] = ("bwd", (rays, beams, scal, ct, mask,
                                                 e))
    _, keep = CS.phase_breakdown(dev)
    out["config-2 full fwd"] = ("fwd", keep["full"])
    rec = []
    orig = CS._event_timed(BG, "gather_forward", rec)
    try:
        CS.render_smoke(dev, CS.SMOKE_SIZE, CS.SMOKE_PHOTONS, 1,
                        startiteration=1, enditeration=2)
    finally:
        BG.gather_forward = orig
    torch.cuda.synchronize()
    tiles = {a[0].shape[0]: a for _, _, _, a in rec}
    out["config-3 full fwd (hetero)"] = ("fwd", tiles[max(tiles)])
    out["config-3 1-tile fwd (hetero)"] = ("fwd", tiles[1])
    scene, cam = CS.fog_box(dev, CS.SPEC_WH)
    cfg = PB.PhotonBeamConfig(
        maxdepth=CS.MAXDEPTH, photonsperiteration=CS.SPEC_PHOTONS,
        initialbeamradius=0.1, gather="auto", grad_geometry=False,
        grad_extras=False)
    _, rec = CS.capture_backward(
        lambda: CS.timed_step(scene, cam, CS.SPEC_WH, cfg, 0))
    labels = {CS.SPEC_WH ** 2 // BG.TILE: "full",
              CS.SPEC_WH ** 2 // 4 // BG.TILE: "r4"}
    for beams_s, rays_s, scal_s, mask_s, ct_s, _, extras in rec:
        label = labels.get(rays_s.shape[0])
        if label and f"spec {label} bwd" not in out:
            out[f"spec {label} bwd"] = ("bwd", (
                rays_s, beams_s, scal_s, BG.pack_ct(ct_s, rays_s.shape[0]),
                mask_s, extras))
    for label in [k for k, (kind, _) in out.items() if kind == "fwd"]:
        mask = out[label][1][3]
        n_chunks, n_tiles = mask.shape
        default = PB.default_sparse_cap(n_chunks * BG.CHUNK, n_tiles * BG.TILE)
        for what, cap in (("grid", mask.numel()), ("default", default)):
            out[label.replace(" fwd", f" id lists, {what} cap")] = (
                "lists", (mask, cap))
    return out


def runner(mods, kind, args):
    """The sparse wrapper of one tree on one sweep, its lists built by this
    tree's code (the lists are the same in every tree); or, for "lists",
    that tree's build of both id lists."""
    g, gb = mods
    if kind == "lists":
        mask, cap = args
        return lambda: (g.sparse_block_ids(mask, cap)[0],
                        gb.sparse_block_ids_chunk_major(mask, cap)[0])
    if kind == "fwd":
        rays, beams, scal, mask = args
        idx, _ = G.sparse_block_ids(mask, mask.numel())
        return lambda: g.gather_sparse(rays, beams, scal, idx)
    rays, beams, scal, ct, mask, extras = args
    idx_t, _ = G.sparse_block_ids(mask, mask.numel())
    idx_c, _ = GB.sparse_block_ids_chunk_major(mask, mask.numel())
    return lambda: gb.gather_backward_sparse(rays, beams, scal, ct, idx_t,
                                             idx_c, extras)


def reps_for(fn):
    """Calls per timing: 3 for a sweep of tens of ms, more for a short one
    (its host launches set its time, and they vary more)."""
    ms, _ = CS.cuda_ms(fn, 1, warm=False)
    return max(3, min(100, int(30 / max(ms, 1e-3))))


def device_split(trees, cases, labels, reps=20):
    """{label: {tree: per call: wall ms, device ms and kernel launches}} of
    the short cases, from one torch.profiler run (a process records
    kernels in its first one only): each tree's calls run in a range of
    their own that ends in a synchronize, so its device kernels lie inside
    it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for label in labels:
            kind, args = cases[label]
            for n, mods in trees.items():
                fn = runner(mods, kind, args)
                fn()
                torch.cuda.synchronize()
                with record_function(f"ab|{label}|{n}"):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
    events = prof.events()
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ab|")]  # the ranges' device rows
    out = {}
    for e in events:
        if not e.name.startswith("ab|"):
            continue
        _, label, n = e.name.split("|")
        s, t = e.time_range.start, e.time_range.end
        inside = [(b - a, k) for a, b, k in kernels if s <= a and b <= t]
        top = {}
        for d, k in inside:
            top[k[:60]] = top.get(k[:60], 0.0) + d / 1e3 / reps
        out.setdefault(label, {})[n] = dict(
            wall_ms=(t - s) / 1e3 / reps,
            device_ms=sum(d for d, _ in inside) / 1e3 / reps,
            launches=len(inside) / reps,
            top=dict(sorted(top.items(), key=lambda kv: -kv[1])[:4]))
    return out


def same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_sparse_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = CS.card_info(dev)
    specs = dict(a.split("=", 1) for a in sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        trees = {n: load_tree(n, s, tmp) for n, s in specs.items()}
        cases = sweeps(dev)
        names = list(trees)
        times = {label: {n: [] for n in names} for label in cases}
        for label, (kind, args) in cases.items():
            ref = None
            for n in names + names[::-1]:
                fn = runner(trees[n], kind, args)
                out = fn()
                if ref is None:
                    ref = out
                elif not same(out, ref):
                    raise AssertionError(f"{n} differs from {names[0]} on "
                                         f"{label}")
                ms, _ = CS.cuda_ms(fn, reps_for(fn), warm=False)
                times[label][n].append(ms)
            del ref
            print(f"[ab] {label}: " + json.dumps(
                {n: [round(t, 3) for t in v] for n, v in
                 times[label].items()}) + "; all bit-identical", flush=True)
        short = [label for label, t in times.items()
                 if min(min(v) for v in t.values()) < 5.0]
        split = device_split(trees, cases, short)
        for label, per in split.items():
            print(f"[ab] {label} per call: {json.dumps(per)}", flush=True)
    res = dict(card=card, specs=specs, ms=times, device_split=split,
               mean_ms={label: {n: float(np.mean(v)) for n, v in t.items()}
                        for label, t in times.items()})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sparse_ab.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res["mean_ms"]))


if __name__ == "__main__":
    main()
