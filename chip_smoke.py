"""Smoke test of the bre_tpu_torch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero; no phase catches
its own failure and nothing falls back to the CPU or a plain version):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: compile bre_tpu_torch/csrc/ with nvcc (or load the cached build);
  The forward path, the progressive render:
  3. main path: the Cornell box filled with fog (examples/cornell_fog.py,
     BASELINE config 2) rendered once through SceneBuilder +
     render_photonbeam at 256x256 and 1,000,000 photons per iteration,
     2 iterations, maxdepth 5, gather="auto", with gather_sparse_cap raised
     to the block grid: every full-film sweep then takes the sparse kernel
     and every ray-budget sweep the dense one.  The launch counters are set
     to 0 just before this render and read just after; both forward kernels
     must have launched.  These are their counts in the kernels line;
  4. default pick: the same render with the default sparse cap (at config 2
     it picks the dense kernel on every sweep), timed per iteration, with
     its own launch counts; its image must equal phase 3's;
  5. breakdown: one more iteration of the default render, each phase timed
     on a synchronized host clock and each kernel launch with CUDA events;
     the packed inputs of its full-film sweep and its R/4 ray-budget sweep
     are kept for phase 6;
  6. kernel parity: both forward kernels against their plain PyTorch
     versions on those main-path inputs, rtol 2e-4 / atol 1e-8, each timed
     with CUDA events after a warm-up, beside its bound;
  7. device consistency: a 64x64, 20,000-photon, 1-iteration render on the
     card (kernels) and on the CPU (plain versions) must agree.
  The training path, a forward+backward iteration in the medium parameters:
  8. bench step: bench.py's fog box at 128x128, 50,000 photons, maxdepth 5,
     radius 0.2, gather="pallas", grad_extras=False: mean(Ld) and its
     gradient in sigma_a and sigma_s, one warm step and 3 timed steps (other
     iteration indices, synchronized host clock); the packed inputs and
     cotangents of the warm step's sweeps are kept for phase 11;
  9. spec step: the same scene at 256x256, 1,000,000 photons, radius 0.1,
     gather="auto": a warm step (its R/4 and full-film sweeps kept), a timed
     step with the default cap (peak memory), then the counted run, the
     same step with gather_sparse_cap at the block grid: the counters are
     set to 0 just before it and read just after, all four kernels must
     launch, and its gradients must agree with the default-cap step's;
 10. trainer: optimize_medium, 3 Adam steps on config 2 (256x256, 1M
     photons, radius 0.12, grad_extras=True) fitting sigma_a and sigma_s
     from sigma_s x 0.5 to a config-2 render at the true parameters; the
     counters are set to 0 just before and read just after, and the dense
     forward and backward kernels (the default cap's pick) must launch;
 11. backward parity: both backward kernels against their plain versions on
     the bench step's sweeps (want_extras both ways) and on the spec step's
     R/4 sweep, max|d| <= 2e-4 * (max|ref| + 1e-9) per cotangent (d tr,
     d sigma_s, d g, d cam_radius, d power_start, d power_end, d radius,
     each against its own max|ref|); dense and sparse bit for bit; both
     timed on the spec step's full-film and R/4 sweeps beside their bounds
     (the plain backward at full film would take minutes and is not run
     there);
 12. gradient consistency: CUDA against CPU gradients of a 32x32,
     4,000-photon config-2 step.

Prints, before the last line, one JSON line with each kernel's launches
(phase 3 for the forward kernels, phase 9's counted run for the backward
ones), max abs error (and, for the backward kernels, max |diff| / max|ref|
per cotangent), time beside its plain version's and its bound; the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.  Details go to chiprun_out/chip_smoke.json.  Exits nonzero
without a card.
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
from bre_tpu_torch.integrators import inverse as INV  # noqa: E402
from bre_tpu_torch.integrators import photonbeam as PB  # noqa: E402
from bre_tpu_torch.integrators.photon_trace import trace_photon_beams  # noqa: E402
from bre_tpu_torch.lights import light_power_distribution  # noqa: E402
from bre_tpu_torch.ops import cuda_build  # noqa: E402
from bre_tpu_torch.ops import gather as G  # noqa: E402
from bre_tpu_torch.ops import gather_bwd as GB  # noqa: E402
from bre_tpu_torch.parallel import mesh as MESH  # noqa: E402
from bre_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from bre_tpu_torch.scene.camera import make_perspective_camera  # noqa: E402

RTOL, ATOL = 2e-4, 1e-8  # tests/test_pallas_gather.py:47
BWD_RTOL = 2e-4  # max|d| <= 2e-4 (max|ref| + 1e-9), tests/test_pallas_gather.py:448
# CUDA vs CPU image means: both run the same PCG32 streams and the same
# operation order; exp/log/sin/cos differ in the last ulp between the
# devices' math libraries, which can flip a photon's scatter or roulette
# decision.  One flipped path moves the image mean by about 1/20,000 of
# itself, so 1e-3 allows some twenty flips.
CONSISTENCY_RTOL = 1e-3
# CUDA vs CPU gradients of the 32x32, 4,000-photon step: the same streams;
# one flipped path of 4,000 moves a gradient by about 1/4,000 of its
# largest entry, so 2e-3 * max|cpu| allows some eight flips.
GRAD_CONSISTENCY_RTOL = 2e-3
FWD_SOURCE = "bre_tpu_torch/csrc/beam_gather_fwd.cu"
BWD_SOURCE = "bre_tpu_torch/csrc/beam_gather_bwd.cu"
# name, module, TPU kernel it replaces, source
KERNELS = (
    ("gather_forward", G, "bre_tpu/ops/pallas_gather.py:245", FWD_SOURCE),
    ("gather_sparse", G, "bre_tpu/ops/pallas_gather.py:425", FWD_SOURCE),
    ("gather_backward_fused", GB, "bre_tpu/ops/pallas_gather_bwd.py:373",
     BWD_SOURCE),
    ("gather_backward_sparse", GB, "bre_tpu/ops/pallas_gather_bwd.py:607",
     BWD_SOURCE),
)
FWD_KERNELS = KERNELS[:2]
SIZE, PHOTONS, ITERS, MAXDEPTH = 256, 1_000_000, 2, 5  # BASELINE config 2
BENCH_WH, BENCH_PHOTONS = 128, 50_000  # bench.py:70-71
SPEC_WH, SPEC_PHOTONS = 256, 1_000_000  # bench.py:125

# Roofline bounds: the larger of the FP32 operations over
# 67 TFLOP/s and the bytes (each input read once, each output written once)
# over 3.35 TB/s, NVIDIA H100 SXM at 700 W.  Operations per pair, counted
# from csrc/ (pair_math.cuh, beam_gather_fwd.cu, beam_gather_bwd.cu): each
# rounded multiply, add or subtract, each min, max and comparison is one;
# each divide, rsqrt, exp and log (SFU) is one more.  The peak counts an
# FMA as two, and the SFU issues at 1/8 of the FP32 rate, so these bounds
# are below what the kernels' own instruction mix allows.  Per-ray and
# per-beam terms (once per staged tile or chunk) are left out: under 0.1%.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# every pair of a live block: closest points and r^2 < 1 (57 FP32 + 1 divide)
GEOM_OPS = 58
# every in-range pair, forward: phase, kernel, 1/sin and three channels of
# power and transmittance (49 FP32 + 2 rsqrt + 3 exp)
FWD_IN_OPS = 54
# every in-range pair, backward, both cotangent sets from one pass over the
# terms they share (68 FP32 + 2 rsqrt + 3 exp); the extras' derivatives and
# sums add 39 FP32
BWD_IN_OPS, BWD_EXTRAS_OPS = 73, 39


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


def launches(kernels=KERNELS):
    return {name: getattr(mod, name).launches for name, mod, _, _ in kernels}


def reset_launches():
    for name, mod, _, _ in KERNELS:
        getattr(mod, name).launches = 0


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


def cornell_camera(dev, size):
    return make_perspective_camera(
        tfm.look_at((0, 0, -2.2), (0, 0, 1), (0, 1, 0)), 50.0, size, size,
        device=dev)


def render(dev, size, photons, iters, **over):
    scene = cornell_fog(dev)
    cam = cornell_camera(dev, size)
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


def live_blocks(mask, scal):
    """(tiles, chunks) of one sweep's live blocks, tile-major."""
    n_chunks = mask.shape[0]
    live = G._live_chunks(n_chunks, BG.CHUNK, scal[0, 3], mask.device)
    return torch.nonzero((live[:, None] & (mask > 0)).T, as_tuple=True)


def pairs_in_range(rays, beams, scal, mask):
    """Pairs of one sweep's live blocks inside the blur width, counted with
    the plain geometry (the data-dependent part of the bounds)."""
    tiles, chunks = live_blocks(mask, scal)
    nb = (1 << 24) // (BG.TILE * BG.CHUNK)
    total = torch.zeros((), dtype=torch.int64, device=rays.device)
    for lo in range(0, tiles.shape[0], nb):
        q = G.pair_geometry_ref(rays[tiles[lo:lo + nb]],
                                beams[chunks[lo:lo + nb]], scal[0, 0],
                                scal[0, 2])
        total += q["in_range"].sum().to(torch.int64)
    return int(total), int(tiles.shape[0])


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, n_bytes):
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# The forward path (phases 3-7)
# ---------------------------------------------------------------------------

def phase_main_path(dev):
    n_chunks = -(-PHOTONS * (MAXDEPTH + 2) // BG.CHUNK)  # beam slots / chunk
    grid = n_chunks * (SIZE * SIZE // BG.TILE)
    reset_launches()
    img, stats, per_iter = render(dev, SIZE, PHOTONS, ITERS,
                                  gather_sparse_cap=grid)
    counts = launches(FWD_KERNELS)
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
    counts = launches(FWD_KERNELS)
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
              for n, _, _, _ in FWD_KERNELS]
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
    results = {name: dict(name=name, route="cuda", source=src, replaces=rep,
                          max_abs_err=0.0, max_rel_err=0.0, sweeps={},
                          sweep="config-2 full film", library_ms=None)
               for name, _, rep, src in FWD_KERNELS}
    for label in ("full", "r4"):
        rays, beams, scal, mask = sweeps[label]
        n_live = int((mask > 0).sum())
        n_valid_chunks = -(-int(scal[0, 3]) // BG.CHUNK)
        idx, _ = G.sparse_block_ids(mask, n_live)
        idx1, _ = G.sparse_block_ids(mask[:, :1].contiguous(), mask.shape[0])
        in_range, n_blocks = pairs_in_range(rays, beams, scal, mask)
        ops = n_blocks * BG.TILE * BG.CHUNK * GEOM_OPS + in_range * FWD_IN_OPS
        out_bytes = rays.shape[0] * G.OUT_ROWS * BG.TILE * 4
        log(f"[parity] {label} sweep: rays {tuple(rays.shape)} beams "
            f"{tuple(beams.shape)} ({n_valid_chunks} chunks hold valid "
            f"beams), live blocks {n_live} of {mask.numel()}, {n_blocks} "
            f"before n_valid; pairs in range {in_range}")
        outs = []
        for name, kern, plain, warm, inputs in (
                ("gather_forward",
                 lambda: G.gather_forward(rays, beams, scal, mask),
                 lambda: G.gather_forward_ref(rays, beams, scal, mask),
                 lambda: G.gather_forward_ref(rays[:1], beams, scal,
                                              mask[:, :1]),
                 (rays, beams, scal, mask)),
                ("gather_sparse",
                 lambda: G.gather_sparse(rays, beams, scal, idx),
                 lambda: G.gather_sparse_ref(rays, beams, scal, idx),
                 lambda: G.gather_sparse_ref(rays[:1], beams, scal, idx1),
                 (rays, beams, scal, idx))):
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
            bound_ms, bound_by = bound(ops, nbytes(*inputs) + out_bytes)
            log(f"[parity] {label} {name}: max rel err {rel_err:.3e} max abs "
                f"err {abs_err:.3e} (|ref| max {float(ref.abs().max()):.3e}) "
                f"allclose(rtol={RTOL}, atol={ATOL}) {ok}; kernel {ms:.3f} "
                f"ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by})")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on the {label} sweep")
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], abs_err)
            r["max_rel_err"] = max(r["max_rel_err"], rel_err)
            r["sweeps"][label] = dict(
                ms=ms, plain_ms=plain_ms, max_abs_err=abs_err,
                max_rel_err=rel_err, live_blocks=n_live,
                pairs_in_range=in_range, bound_ms=bound_ms, bound_by=bound_by)
            if label == "full":
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
            outs.append(out)
            del ref
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"dense and sparse kernels differ on the "
                                 f"{label} sweep's live blocks")
        log(f"[parity] {label} sweep: dense and sparse kernels agree bit "
            "for bit")
    return [results[name] for name, _, _, _ in FWD_KERNELS]


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


# ---------------------------------------------------------------------------
# The training path (phases 8-12)
# ---------------------------------------------------------------------------

def fog_box(dev, wh):
    """bench.py's scene and camera: a fog box lit from inside, a wall
    behind it."""
    b = SceneBuilder()
    fog = b.homogeneous_medium((0.05,) * 3, (0.5,) * 3, 0.3)
    wall = b.matte((0.6, 0.5, 0.4))
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-3, -3, 3.0), (-3, 3, 3.0), (3, 3, 3.0), (3, -3, 3.0),
           material=wall)
    b.point_light((0.0, 0.3, 0.0), (1.0, 0.9, 0.8), medium=fog)
    cam = make_perspective_camera(
        tfm.look_at((0, 0, -3.5), (0, 0, 0), (0, 1, 0)), 45.0, wh, wh,
        device=dev)
    return b.build(device=dev), cam


def fwd_bwd(scene, cam, wh, cfg, iter_idx, params=("sigma_a", "sigma_s")):
    """bench.py's iteration: mean(Ld) of one iteration (detached photon
    sampling, detached gather geometry) and its gradient in ``params``."""
    leaves = {k: getattr(scene.media, k).detach().clone().requires_grad_()
              for k in params}
    sc = scene._replace(media=scene.media._replace(**leaves))
    photons, radius = cfg.photonsperiteration, cfg.initialbeamradius
    beams, _ = trace_photon_beams(sc, light_power_distribution(sc), iter_idx,
                                  photons, cfg.maxdepth, radius,
                                  detach_sampling=True)
    Ld, _ = PB.camera_pass(sc, cam, wh, wh, beams, radius, iter_idx, cfg,
                           photons)
    loss = Ld.mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.detach() for k, g in zip(params, grads)}


def timed_step(*args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = fwd_bwd(*args, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, loss, grads


def check_grads(grads, what):
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
            raise AssertionError(f"{what}: gradient {k} is not finite and "
                                 f"non-zero: {g.tolist()}")


def capture_backward(run):
    """Run ``run()`` with the packed backward recorded: returns its result
    and, per sweep, (beams, rays, scalars, mask, ct, the forward's sparse
    ids or None, grad_extras)."""
    rec = []
    orig = BG._packed_backward

    def wrapped(*args):
        rec.append(tuple(a.detach() if torch.is_tensor(a) else a
                         for a in args))
        return orig(*args)
    BG._packed_backward = wrapped
    try:
        out = run()
    finally:
        BG._packed_backward = orig
    return out, rec


def fmt_values(tensors):
    """A dict of tensors as rounded lists, for the log and the report."""
    return {k: [float(f"{x:.6g}") for x in t.reshape(-1).tolist()]
            for k, t in tensors.items()}


def phase_bench_step(dev):
    wh, photons = BENCH_WH, BENCH_PHOTONS
    scene, cam = fog_box(dev, wh)
    cfg = PB.PhotonBeamConfig(maxdepth=MAXDEPTH, photonsperiteration=photons,
                              initialbeamradius=0.2, gather="pallas",
                              grad_geometry=False, grad_extras=False)
    (t_warm, _, _), sweeps = capture_backward(
        lambda: timed_step(scene, cam, wh, cfg, 0))
    steps = [timed_step(scene, cam, wh, cfg, it) for it in (1, 2, 3)]
    for _, loss, grads in steps:
        if not np.isfinite(loss):
            raise AssertionError(f"bench step: loss {loss}")
        check_grads(grads, "bench step")
    per_step = [t for t, _, _ in steps]
    log(f"[bench] fog box {wh}x{wh}, {photons} photons, maxdepth {MAXDEPTH}, "
        f"radius 0.2, gather=pallas, grad_extras=False: warm step "
        f"{t_warm:.4f} s, s/step {per_step} (mean {np.mean(per_step):.4f}); "
        f"value {steps[-1][1]:.6e}; grads {fmt_values(steps[-1][2])}; "
        f"backward sweeps {[s[1].shape[0] for s in sweeps]} ray tiles")
    return dict(warm_s=t_warm, per_step_s=per_step,
                values=[s[1] for s in steps],
                grads=fmt_values(steps[-1][2])), sweeps


def phase_spec_step(dev):
    wh, photons = SPEC_WH, SPEC_PHOTONS
    scene, cam = fog_box(dev, wh)
    base = dict(maxdepth=MAXDEPTH, photonsperiteration=photons,
                initialbeamradius=0.1, gather="auto", grad_geometry=False,
                grad_extras=False)
    n_chunks = -(-photons * (MAXDEPTH + 2) // BG.CHUNK)
    grid = n_chunks * (wh * wh // BG.TILE)
    cfg_default = PB.PhotonBeamConfig(**base)
    cfg_grid = PB.PhotonBeamConfig(gather_sparse_cap=grid, **base)
    (t_warm, _, _), sweeps = capture_backward(
        lambda: timed_step(scene, cam, wh, cfg_default, 0))
    torch.cuda.reset_peak_memory_stats(dev)
    t_a, loss_a, g_a = timed_step(scene, cam, wh, cfg_default, 1)
    peak = torch.cuda.max_memory_allocated(dev)
    reset_launches()
    t_b, loss_b, g_b = timed_step(scene, cam, wh, cfg_grid, 1)
    counts = launches()
    check_grads(g_a, "spec step")
    check_grads(g_b, "spec step, counted run")
    diff = {k: float((g_a[k] - g_b[k]).abs().max()) for k in g_a}
    identical = all(torch.equal(g_a[k], g_b[k]) for k in g_a)
    log(f"[spec] fog box {wh}x{wh}, {photons} photons, maxdepth {MAXDEPTH}, "
        f"radius 0.1, gather=auto, grad_extras=False: warm step {t_warm:.4f} "
        f"s; default cap {t_a:.4f} s/step, peak memory {peak / 2**30:.3f} "
        f"GiB, value {loss_a:.6e}, grads {fmt_values(g_a)}; counted run "
        f"(gather_sparse_cap={grid}, the block grid) {t_b:.4f} s/step, value "
        f"{loss_b:.6e}, launches {counts}; grads max |diff| {diff}, "
        f"bit-identical {identical}")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels of the training path never launched "
                             f"in the counted run: {missing} ({counts})")
    for k in g_a:
        if not diff[k] <= BWD_RTOL * (float(g_a[k].abs().max()) + 1e-9):
            raise AssertionError(f"spec step: default-cap and sparse-cap "
                                 f"gradients of {k} disagree ({diff[k]})")
    breakdown = spec_breakdown(scene, cam, wh, cfg_default)
    by_tiles = {wh * wh // BG.TILE: "full", wh * wh // 4 // BG.TILE: "r4"}
    keep = {}
    for args in sweeps:
        label = by_tiles.get(args[1].shape[0])
        if label and label not in keep:
            keep[label] = args
    if set(keep) != {"full", "r4"}:
        raise AssertionError(f"spec step saw backward sweeps {sorted(keep)}, "
                             "expected a full-film and an R/4 sweep")
    return dict(warm_s=t_warm, default_cap_s=t_a, counted_s=t_b,
                peak_memory_bytes=peak, value=loss_a, value_counted=loss_b,
                grads=fmt_values(g_a), grads_max_abs_diff=diff,
                grads_bit_identical=identical, sparse_cap=grid,
                launches=counts, breakdown=breakdown), keep


def spec_breakdown(scene, cam, wh, cfg):
    """One more default-cap spec step, phase by phase: the photon trace and
    the camera pass (forward, synchronized host clock), every kernel launch
    (CUDA events), the backward as the rest of the step."""
    phases, launches_ = [], []
    me = sys.modules[__name__]
    saved = [(me, "trace_photon_beams",
              _host_timed(me, "trace_photon_beams", phases)),
             (PB, "camera_pass", _host_timed(PB, "camera_pass", phases))]
    saved += [(BG, n, _event_timed(BG, n, launches_))
              for n, _, _, _ in KERNELS]
    try:
        step_s, _, _ = timed_step(scene, cam, wh, cfg, 1)
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)
    torch.cuda.synchronize()
    fwd = dict(phases)
    labels = {wh * wh // BG.TILE: "full", wh * wh // 4 // BG.TILE: "r4"}
    kernels = {}
    for name, e0, e1, args in launches_:
        key = f"{name} {labels.get(args[0].shape[0], f'{args[0].shape[0]} tiles')}"
        kernels[key] = kernels.get(key, 0.0) + e0.elapsed_time(e1)
    bwd_ms = sum(v for k, v in kernels.items() if "backward" in k)
    out = dict(step_s=step_s, trace_fwd_s=fwd["trace_photon_beams"],
               camera_pass_fwd_s=fwd["camera_pass"], kernels_ms=kernels,
               backward_s=step_s - sum(fwd.values()),
               backward_kernels_s=bwd_ms / 1e3)
    out["backward_rest_s"] = out["backward_s"] - out["backward_kernels_s"]
    log(f"[spec breakdown] step {step_s:.4f} s: trace (fwd) "
        f"{out['trace_fwd_s']:.4f} s, camera pass (fwd, with its gathers) "
        f"{out['camera_pass_fwd_s']:.4f} s, backward {out['backward_s']:.4f} "
        f"s of which kernels {out['backward_kernels_s']:.4f} s and the rest "
        f"(autograd through the trace, the camera pass and the packing) "
        f"{out['backward_rest_s']:.4f} s; kernel ms by sweep "
        + json.dumps({k: round(v, 3) for k, v in kernels.items()}))
    return out


def phase_trainer(dev):
    scene = cornell_fog(dev)
    cam = cornell_camera(dev, SIZE)
    cfg = PB.PhotonBeamConfig(maxdepth=MAXDEPTH, photonsperiteration=PHOTONS,
                              initialbeamradius=0.12, alpha=0.7,
                              gather="auto", grad_geometry=False,
                              grad_extras=True)
    run = MESH.sharded_photonbeam_iteration(
        scene, cam, SIZE, SIZE, cfg, light_power_distribution(scene))
    with torch.no_grad():
        target = run(100, 0.12).reshape(SIZE, SIZE, 3)
    start = dict(sigma_a=scene.media.sigma_a, sigma_s=scene.media.sigma_s * 0.5,
                 g=scene.media.g)
    marks = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params, losses = INV.optimize_medium(
        scene, cam, SIZE, SIZE, target, cfg,
        INV.InverseConfig(steps=3, learning_rate=2e-2, n_devices=1,
                          optimize=("sigma_a", "sigma_s")),
        init_params=start,
        callback=lambda it, loss, p: marks.append(time.perf_counter()))
    counts = launches()
    per_step = np.diff([t0] + marks).tolist()
    moved = {k: float((params[k] - start[k]).abs().max())
             for k in ("sigma_a", "sigma_s")}
    log(f"[trainer] optimize_medium, config 2 {SIZE}x{SIZE}, {PHOTONS} "
        f"photons, radius 0.12, grad_extras=True, Adam lr 2e-2 on sigma_a, "
        f"sigma_s from sigma_s x 0.5: s/step {per_step} (steps 2-3 mean "
        f"{np.mean(per_step[1:]):.4f}); losses {losses}; "
        f"params {fmt_values(params)}; moved {moved}; launches {counts}")
    if not all(np.isfinite(losses)) or not min(moved.values()) > 0:
        raise AssertionError(f"trainer: losses {losses}, moved {moved}")
    # the default cap picks the dense kernels at config 2, forward and back
    missing = [k for k in ("gather_forward", "gather_backward_fused")
               if counts[k] <= 0]
    if missing:
        raise AssertionError(f"trainer: kernels never launched: {missing} "
                             f"({counts})")
    return dict(per_step_s=per_step, losses=losses, params=fmt_values(params),
                moved=moved, launches=counts)


def _bwd_close(out, ref, what):
    """Each cotangent (its rows of d_rays or d_beams, gather_bwd.D_RAYS_ROWS
    and D_BEAMS_ROWS) held to the criterion against its own max|ref|, so the
    large d sigma_s and d power rows cannot hide the small d tr, d g and
    d radius rows; the other rows of d_beams must be zero.  Returns
    {cotangent: (max |diff|, max |diff| / (max|ref| + 1e-9))}."""
    errs = {}
    for o, r, part, rows in zip(out, ref, ("d_rays", "d_beams"),
                                (GB.D_RAYS_ROWS, GB.D_BEAMS_ROWS)):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{what}: non-finite {part}")
        for name, sl in rows.items():
            err = float((o[:, sl] - r[:, sl]).abs().max())
            r_max = float(r[:, sl].abs().max())
            if not err <= BWD_RTOL * (r_max + 1e-9):
                raise AssertionError(f"{what}: d {name} max |diff| {err}, "
                                     f"max |ref| {r_max}")
            errs[name] = (err, err / (r_max + 1e-9))
    other = torch.ones(G.NB, dtype=torch.bool, device=out[1].device)
    for sl in GB.D_BEAMS_ROWS.values():
        other[sl] = False
    if float(out[1][:, other].abs().max()) != 0.0:
        raise AssertionError(f"{what}: d_beams geometry rows are not zero")
    return errs


def _bwd_case(args, want_extras):
    beams, rays, scal, mask, ct = args[:5]
    ct_p = BG.pack_ct(ct, rays.shape[0])
    n_live = int((mask > 0).sum())
    idx_t, _ = G.sparse_block_ids(mask, n_live)
    idx_c, _ = GB.sparse_block_ids_chunk_major(mask, n_live)
    dense = lambda: GB.gather_backward_fused(  # noqa: E731
        rays, beams, scal, ct_p, mask, want_extras)
    sparse = lambda: GB.gather_backward_sparse(  # noqa: E731
        rays, beams, scal, ct_p, idx_t, idx_c, want_extras)
    plain = (lambda: GB.gather_backward_fused_ref(  # noqa: E731
                 rays, beams, scal, ct_p, mask, want_extras),
             lambda: GB.gather_backward_sparse_ref(  # noqa: E731
                 rays, beams, scal, ct_p, idx_t, idx_c, want_extras))
    inputs = dict(gather_backward_fused=(rays, beams, scal, ct_p, mask),
                  gather_backward_sparse=(rays, beams, scal, ct_p, idx_t,
                                          idx_c))
    return dense, sparse, plain, inputs, n_live


def _bwd_bound(args, inputs, want_extras):
    beams, rays, scal, mask = args[:4]
    in_range, n_blocks = pairs_in_range(rays, beams, scal, mask)
    ops = (n_blocks * BG.TILE * BG.CHUNK * GEOM_OPS
           + in_range * (BWD_IN_OPS + (BWD_EXTRAS_OPS if want_extras else 0)))
    out_bytes = nbytes(rays[:, :GB.NDR], beams)  # d_rays and d_beams
    return {name: bound(ops, nbytes(*ins) + out_bytes)
            for name, ins in inputs.items()}, in_range


def phase_bwd_parity(bench_sweeps, spec_sweeps):
    names = [k[0] for k in KERNELS[2:]]
    results = {name: dict(name=name, route="cuda", source=src, replaces=rep,
                          max_abs_err=0.0, sweeps={},
                          sweep="spec step R/4 budget", library_ms=None,
                          err_over_max_ref={})
               for name, _, rep, src in KERNELS[2:]}
    cases = [(f"bench {a[1].shape[0]} tiles #{i}", a, extras)
             for i, a in enumerate(bench_sweeps) for extras in (False, True)]
    cases.append(("spec r4", spec_sweeps["r4"], spec_sweeps["r4"][6]))
    for label, args, extras in cases:
        dense, sparse, plain, inputs, n_live = _bwd_case(args, extras)
        outs = [dense(), sparse()]
        torch.cuda.synchronize()
        for name, out, ref_fn in zip(names, outs, plain):
            plain_ms, ref = cuda_ms(ref_fn, 1, warm=False)
            errs = _bwd_close(out, ref, f"{name} ({label})")
            r = results[name]
            r["max_abs_err"] = max([r["max_abs_err"]]
                                   + [e for e, _ in errs.values()])
            for k, (_, rel) in errs.items():
                r["err_over_max_ref"][k] = max(
                    r["err_over_max_ref"].get(k, 0.0), rel)
            r["sweeps"][f"{label} extras={extras}"] = dict(
                plain_ms=plain_ms, live_blocks=n_live,
                max_abs_err={k: e for k, (e, _) in errs.items()},
                err_over_max_ref={k: rel for k, (_, rel) in errs.items()})
            if label == "spec r4":
                r["plain_ms"] = plain_ms
            del ref
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"dense and sparse backward kernels differ "
                                 f"on the {label} sweep")
        for n in names:
            sw = results[n]["sweeps"][f"{label} extras={extras}"]
            log(f"[bwd parity] {label} ({args[1].shape[0]} ray tiles, "
                f"{n_live} live blocks, want_extras={extras}) {n}: plain "
                f"{sw['plain_ms']:.3f} ms; per cotangent max |diff| / "
                f"max|ref| "
                + json.dumps({k: float(f"{v:.3e}") for k, v in
                              sw["err_over_max_ref"].items()})
                + ", max |diff| "
                + json.dumps({k: float(f"{v:.3e}") for k, v in
                              sw["max_abs_err"].items()}))
        log(f"[bwd parity] {label}: dense and sparse agree bit for bit")
    for label in ("r4", "full"):
        args = spec_sweeps[label]
        extras = args[6]
        dense, sparse, _, inputs, n_live = _bwd_case(args, extras)
        bounds, in_range = _bwd_bound(args, inputs, extras)
        for name, fn in zip(names, (dense, sparse)):
            ms, _ = cuda_ms(fn, 3)
            bound_ms, bound_by = bounds[name]
            gpairs = n_live * BG.TILE * BG.CHUNK / ms / 1e6
            results[name]["sweeps"][f"spec {label} timing"] = dict(
                ms=ms, live_blocks=n_live, gpairs_s=gpairs,
                pairs_in_range=in_range, bound_ms=bound_ms,
                bound_by=bound_by)
            if label == "r4":
                results[name].update(ms=ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
            log(f"[bwd timing] spec {label} sweep ({args[1].shape[0]} ray "
                f"tiles x {args[0].shape[0]} chunks, {n_live} live blocks, "
                f"{in_range} pairs in range): {name} {ms:.3f} ms, "
                f"{gpairs:.1f} Gpairs/s, bound {bound_ms:.3f} ms "
                f"({bound_by})" + ("" if label == "r4" else
                                   "; plain version not run at full film "
                                   "(minutes)"))
    return [results[name] for name in names]


def phase_grad_consistency(dev):
    wh, photons = 32, 4000
    out = []
    for d in (dev, torch.device("cpu")):
        scene = cornell_fog(d)
        cfg = PB.PhotonBeamConfig(
            maxdepth=MAXDEPTH, photonsperiteration=photons,
            initialbeamradius=0.12, gather="auto", grad_geometry=False,
            grad_extras=True, tr_crossings=PB.default_tr_crossings(scene))
        out.append(fwd_bwd(scene, cornell_camera(d, wh), wh, cfg, 1,
                           params=("sigma_a", "sigma_s", "g")))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    rel = {k: float((g_gpu[k].cpu() - g_cpu[k]).abs().max()
                    / g_cpu[k].abs().max()) for k in g_cpu}
    log(f"[grad consistency] config 2 {wh}x{wh}, {photons} photons, "
        f"grad_extras=True: value CUDA {l_gpu:.7e} CPU {l_cpu:.7e}; grads "
        f"CPU {fmt_values(g_cpu)}; max |diff| / max |cpu| {rel} (limit "
        f"{GRAD_CONSISTENCY_RTOL})")
    check_grads(g_cpu, "CPU step")
    if not (abs(l_gpu / l_cpu - 1) <= CONSISTENCY_RTOL
            and max(rel.values()) <= GRAD_CONSISTENCY_RTOL):
        raise AssertionError("CUDA and CPU gradients disagree")
    return dict(value_cuda=l_gpu, value_cpu=l_cpu, grad_rel_diff=rel)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    t_start = time.perf_counter()
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
    report["bench_step"], bench_sweeps = phase_bench_step(dev)
    report["spec_step"], spec_sweeps = phase_spec_step(dev)
    report["trainer"] = phase_trainer(dev)
    kernels += phase_bwd_parity(bench_sweeps, spec_sweeps)
    del bench_sweeps, spec_sweeps
    report["grad_consistency"] = phase_grad_consistency(dev)
    counted = {**report["main"]["launches"],
               **{k: v for k, v in report["spec_step"]["launches"].items()
                  if k not in report["main"]["launches"]}}
    for k in kernels:
        k["launches"] = counted[k["name"]]
    report["kernels"] = kernels
    report["command_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['command_s']:.1f} s from start to the kernels line")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "sweep")
    rows = [{k: kk[k] for k in keys} for kk in kernels]
    for row, kk in zip(rows, kernels):  # backward kernels: per cotangent
        if "err_over_max_ref" in kk:
            row["err_over_max_ref"] = kk["err_over_max_ref"]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
