"""Smoke test of the bre_tpu_torch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile bre_tpu_torch/csrc/ with nvcc (or load the cached build);
  3. main path: the Cornell box filled with fog (examples/cornell_fog.py,
     BASELINE config 2) rendered once through SceneBuilder +
     render_photonbeam at 256x256 and 1,000,000 photons per iteration,
     2 iterations, maxdepth 5, gather="auto", with gather_sparse_cap raised
     to the block grid: every full-film sweep then takes the sparse kernel
     and every ray-budget sweep the dense one.  The launch counters are set
     to 0 just before this render and read just after; each kernel must
     have launched.  These are the counts of the kernels line;
  4. default pick: the same render with the default sparse cap (at config 2
     it picks the dense kernel on every sweep), timed per iteration, with
     its own launch counts; its image must equal phase 3's;
  5. breakdown: one more iteration of the default render, each phase timed
     on a synchronized host clock and each kernel launch with CUDA events;
     the packed inputs of its full-film sweep and its R/4 ray-budget sweep
     are kept for phase 6;
  6. kernel parity: both forward kernels against their plain PyTorch
     versions on those main-path inputs, rtol 2e-4 / atol 1e-8, each timed
     with CUDA events after a warm-up;
  7. device consistency: a 64x64, 20,000-photon, 1-iteration render on the
     card (kernels) and on the CPU (plain versions) must agree.

Prints, before the last line, one JSON line with each kernel's launches
(phase 3), max abs error over both sweeps, and time on the full-film sweep
beside its plain version's; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details go to chiprun_out/chip_smoke.json.  Exits nonzero without a card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from bre_tpu_torch.accel import beam_gather as BG  # noqa: E402
from bre_tpu_torch.core import transform as tfm  # noqa: E402
from bre_tpu_torch.integrators import photonbeam as PB  # noqa: E402
from bre_tpu_torch.ops import cuda_build  # noqa: E402
from bre_tpu_torch.ops import gather as G  # noqa: E402
from bre_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from bre_tpu_torch.scene.camera import make_perspective_camera  # noqa: E402

RTOL, ATOL = 2e-4, 1e-8  # tests/test_pallas_gather.py:47
# CUDA vs CPU image means: both run the same PCG32 streams and the same
# operation order; exp/log/sin/cos differ in the last ulp between the
# devices' math libraries, which can flip a photon's scatter or roulette
# decision.  One flipped path moves the image mean by about 1/20,000 of
# itself, so 1e-3 allows some twenty flips.
CONSISTENCY_RTOL = 1e-3
SOURCE = "bre_tpu_torch/csrc/beam_gather_fwd.cu"
KERNELS = (("gather_forward", "bre_tpu/ops/pallas_gather.py:245"),
           ("gather_sparse", "bre_tpu/ops/pallas_gather.py:425"))
SIZE, PHOTONS, ITERS, MAXDEPTH = 256, 1_000_000, 2, 5  # BASELINE config 2


def log(*a):
    print(*a, flush=True)


def card_info(dev):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name_power = smi.stdout.strip().splitlines()[dev.index or 0]
    log(name_power)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(dev)}")
    return name_power


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of fn() over reps calls, CUDA events; returns
    (ms, last result)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def launches():
    return {name: getattr(G, name).launches for name, _ in KERNELS}


def reset_launches():
    for name, _ in KERNELS:
        getattr(G, name).launches = 0


def cornell_fog(dev):
    """examples/cornell_fog.py's scene (BASELINE config 2)."""
    b = SceneBuilder()
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
    return b.build(device=dev)


def render(dev, size, photons, iters, **over):
    scene = cornell_fog(dev)
    cam = make_perspective_camera(
        tfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, size, size,
        device=dev)
    cfg = PB.PhotonBeamConfig(
        iterations=iters, maxdepth=MAXDEPTH, photonsperiteration=photons,
        initialbeamradius=0.12, alpha=0.7, gather="auto",
        grad_geometry=False, imagewritefrequency=1, **over)
    marks = []

    def on_write(it, img):  # runs after each iteration, image copied to host
        marks.append(time.perf_counter())

    t0 = time.perf_counter()
    img, stats = PB.render_photonbeam(scene, cam, size, size, cfg,
                                      write_callback=on_write)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    per_iter = np.diff([t0] + marks).tolist()
    return img.float().cpu(), stats, per_iter


def check_image(img, size, what):
    if tuple(img.shape) != (size, size, 3):
        raise AssertionError(f"{what}: image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{what}: non-finite image")
    mean = float(img.mean())
    if not mean > 0.0:
        raise AssertionError(f"{what}: image mean {mean} is not positive")
    return mean


def phase_main_path(dev):
    n_chunks = -(-PHOTONS * (MAXDEPTH + 2) // BG.CHUNK)  # beam slots / chunk
    grid = n_chunks * (SIZE * SIZE // BG.TILE)
    reset_launches()
    img, stats, per_iter = render(dev, SIZE, PHOTONS, ITERS,
                                  gather_sparse_cap=grid)
    counts = launches()
    mean = check_image(img, SIZE, "config-2 render")
    log(f"[main] config 2: {SIZE}x{SIZE}, {PHOTONS} photons/iter, {ITERS} "
        f"iters, maxdepth {MAXDEPTH}, gather=auto, gather_sparse_cap={grid} "
        f"(the block grid): s/iter {per_iter}; live beams/iter "
        f"{stats['n_beams'] / ITERS:.0f}; image mean {mean:.6f}; launches "
        f"{counts}")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels of the main path never launched: "
                             f"{missing} ({counts})")
    return img, dict(per_iter_s=per_iter, image_mean=mean,
                     n_beams=stats["n_beams"], sparse_cap=grid,
                     launches=counts)


def phase_default_pick(dev, img_main):
    reset_launches()
    img, stats, per_iter = render(dev, SIZE, PHOTONS, ITERS)
    counts = launches()
    mean = check_image(img, SIZE, "config-2 render, default cap")
    diff = float((img - img_main).abs().max())
    log(f"[default] config 2, gather=auto, default sparse cap: s/iter "
        f"{per_iter} (mean {np.mean(per_iter):.4f}); live beams/iter "
        f"{stats['n_beams'] / ITERS:.0f}; image mean {mean:.6f}; launches "
        f"{counts}; max |diff| to the main-path image {diff:.3e}")
    if sum(counts.values()) <= 0:
        raise AssertionError(f"no gather kernel launched: {counts}")
    # same blocks in the same order in both kernels: identical images
    if not torch.allclose(img, img_main, rtol=1e-5, atol=1e-7):
        raise AssertionError("default-cap render differs from the main path")
    return dict(per_iter_s=per_iter, image_mean=mean,
                n_beams=stats["n_beams"], launches=counts,
                max_abs_diff_to_main=diff)


def _host_timed(module, name, rec):
    orig = getattr(module, name)

    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        rec.append((name, time.perf_counter() - t0))
        return out
    setattr(module, name, run)
    return orig


def _event_timed(module, name, rec):
    orig = getattr(module, name)

    def run(*a, **k):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = orig(*a, **k)
        e1.record()
        rec.append((name, e0, e1, a))
        return out
    setattr(module, name, run)
    return orig


def phase_breakdown(dev):
    """Iteration 2 of the default render (radius 0.084), phase by phase;
    returns the breakdown and the full-film and R/4 sweeps' inputs."""
    phases, sweeps = [], []
    saved = [(PB, n, _host_timed(PB, n, phases)) for n in
             ("trace_photon_beams", "pack_beams_compact", "camera_pass")]
    saved += [(BG, n, _event_timed(BG, n, sweeps))
              for n, _ in KERNELS]
    try:
        _, stats, per_iter = render(dev, SIZE, PHOTONS, 1, startiteration=1,
                                    enditeration=2)
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)
    torch.cuda.synchronize()
    out = dict(iteration_s=per_iter[0], n_beams=stats["n_beams"],
               phases={n: t for n, t in phases}, sweeps=[])
    keep = {}
    for name, e0, e1, args in sweeps:
        rays, beams, scal, mask = args
        n_live = int((mask > 0).sum()) if name == "gather_forward" else None
        ms = e0.elapsed_time(e1)
        out["sweeps"].append(dict(kernel=name, ray_tiles=rays.shape[0],
                                  chunks=beams.shape[0], live_blocks=n_live,
                                  ms=ms))
        label = {SIZE * SIZE // BG.TILE: "full",
                 SIZE * SIZE // 4 // BG.TILE: "r4"}.get(rays.shape[0])
        if name == "gather_forward" and label and label not in keep:
            keep[label] = args
    log(f"[breakdown] config 2, iteration 2 (radius 0.084), default cap: "
        f"{out['iteration_s']:.4f} s; valid beams {out['n_beams']}; phases "
        + ", ".join(f"{n} {t:.4f} s" for n, t in phases))
    for s in out["sweeps"]:
        gp = (f", {s['live_blocks'] * BG.TILE * BG.CHUNK / s['ms'] / 1e6:.1f}"
              " Gpairs/s" if s["live_blocks"] else "")
        log(f"[breakdown]   {s['kernel']}: {s['ms']:.3f} ms, {s['ray_tiles']} "
            f"ray tiles x {s['chunks']} chunks, live blocks "
            f"{s['live_blocks']}{gp}")
    if set(keep) != {"full", "r4"}:
        raise AssertionError(f"breakdown saw sweeps {sorted(keep)}, expected "
                             "a full-film and an R/4 sweep")
    return out, keep


def phase_parity(sweeps):
    results = {name: dict(name=name, route="cuda", source=SOURCE,
                          replaces=rep, max_abs_err=0.0, max_rel_err=0.0,
                          sweeps={})
               for name, rep in KERNELS}
    for label in ("full", "r4"):
        rays, beams, scal, mask = sweeps[label]
        n_live = int((mask > 0).sum())
        n_valid_chunks = -(-int(scal[0, 3]) // BG.CHUNK)
        idx, _ = G.sparse_block_ids(mask, n_live)
        idx1, _ = G.sparse_block_ids(mask[:, :1].contiguous(), mask.shape[0])
        log(f"[parity] {label} sweep: rays {tuple(rays.shape)} beams "
            f"{tuple(beams.shape)} ({n_valid_chunks} chunks hold valid "
            f"beams), live blocks {n_live} of {mask.numel()}")
        outs = []
        for name, kern, plain, warm in (
                ("gather_forward",
                 lambda: G.gather_forward(rays, beams, scal, mask),
                 lambda: G.gather_forward_ref(rays, beams, scal, mask),
                 lambda: G.gather_forward_ref(rays[:1], beams, scal,
                                              mask[:, :1])),
                ("gather_sparse",
                 lambda: G.gather_sparse(rays, beams, scal, idx),
                 lambda: G.gather_sparse_ref(rays, beams, scal, idx),
                 lambda: G.gather_sparse_ref(rays[:1], beams, scal, idx1))):
            out = kern()
            torch.cuda.synchronize()
            warm()
            plain_ms, ref = cuda_ms(plain, 1, warm=False)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} ({label}): non-finite output")
            abs_err = float((out - ref).abs().max())
            rel_err = float(((out - ref).abs() / (ref.abs() + ATOL)).max())
            ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
            ms, _ = cuda_ms(kern, 3)
            log(f"[parity] {label} {name}: max rel err {rel_err:.3e} max abs "
                f"err {abs_err:.3e} (|ref| max {float(ref.abs().max()):.3e}) "
                f"allclose(rtol={RTOL}, atol={ATOL}) {ok}; kernel {ms:.3f} "
                f"ms, plain {plain_ms:.3f} ms")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on the {label} sweep")
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["max_rel_err"] = max(r["max_rel_err"], rel_err)
            r["sweeps"][label] = dict(ms=ms, plain_ms=plain_ms,
                                      max_abs_err=abs_err,
                                      max_rel_err=rel_err, live_blocks=n_live)
            if label == "full":
                r["ms"], r["plain_ms"] = ms, plain_ms
            outs.append(out)
            del ref
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"dense and sparse kernels differ on the "
                                 f"{label} sweep's live blocks")
        log(f"[parity] {label} sweep: dense and sparse kernels agree bit "
            "for bit")
    return [results[name] for name, _ in KERNELS]


def phase_consistency(dev):
    size, photons = 64, 20_000
    img_gpu, _, t_gpu = render(dev, size, photons, 1)
    img_cpu, _, t_cpu = render(torch.device("cpu"), size, photons, 1)
    m_gpu = check_image(img_gpu, size, "CUDA render")
    m_cpu = check_image(img_cpu, size, "CPU render")
    ch_gpu, ch_cpu = img_gpu.mean((0, 1)), img_cpu.mean((0, 1))
    rel = float(((ch_gpu - ch_cpu).abs() / ch_cpu).max())
    px = (img_gpu - img_cpu).abs() / (img_cpu.abs() + 1e-6)
    log(f"[consistency] {size}x{size}, {photons} photons, 1 iter: mean CUDA "
        f"{m_gpu:.7f} CPU {m_cpu:.7f}; channel-mean max rel diff {rel:.3e} "
        f"(limit {CONSISTENCY_RTOL}); pixels within 1e-3: "
        f"{float((px < 1e-3).float().mean()):.4f}; s CUDA {t_gpu[0]:.2f} "
        f"CPU {t_cpu[0]:.2f}")
    if not rel <= CONSISTENCY_RTOL:
        raise AssertionError("CUDA and CPU renders disagree")
    return dict(mean_cuda=m_gpu, mean_cpu=m_cpu, channel_rel_diff=rel)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = torch.device("cuda", 0)
    report = {"card": card_info(dev)}
    t0 = time.perf_counter()
    cuda_build.load_library()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] kernels ready in {report['build_s']:.2f} s "
        f"(nvcc {cuda_build.build_seconds} s)")
    img_main, report["main"] = phase_main_path(dev)
    report["default_pick"] = phase_default_pick(dev, img_main)
    report["breakdown"], sweeps = phase_breakdown(dev)
    kernels = phase_parity(sweeps)
    del sweeps
    report["consistency"] = phase_consistency(dev)
    for k in kernels:
        k["launches"] = report["main"]["launches"][k["name"]]
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys} for kk in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
