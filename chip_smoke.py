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
     with CUDA events after a warm-up, beside its bound and the grid its
     wrapper launched (splits per ray tile, blocks); the dense kernel run
     twice, the same bits both times;
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
     each against its own max|ref|); dense and sparse bit for bit, the
     dense kernel twice bit for bit; both timed on the spec step's
     full-film and R/4 sweeps beside their bounds and launched grids (the
     plain backward at full film would take minutes and is not run there),
     and the dense one's kernels timed one by one there under
     torch.profiler, in a child process (the beam pre-pass, the d_rays sweep,
     the split reduction, the d_beams sweep);
 12. gradient consistency: CUDA against CPU gradients of a 32x32,
     4,000-photon config-2 step.

  Grid-density media (BASELINE config 3 and the density gradient), through
  the heterogeneous instances of the kernels:
 13. config-3 render: examples/smoke_hetero.py's scene through
     SceneBuilder.grid_medium + render_photonbeam at 512x512, 100,000
     photons per iteration, 8 iterations, maxdepth 5, radius 0.15, g 0.4,
     a 32^3 grid, gather="pallas"; counters set to 0 before and read after:
     the dense hetero forward kernel must launch (s/iter, valid beams per
     iteration, grid-tracking overflow, image mean);
 14. its counted run: gather_sparse_cap at the block grid, so full-film
     sweeps take the sparse hetero kernel; the image must equal phase 13's
     bit for bit;
 15. hetero forward parity: one more config-3 iteration, timed phase by
     phase; both hetero forward kernels against their plain versions on
     its sweeps (every 4th ray tile of a sweep with more than 400,000 live
     blocks), rtol 2e-4, timed beside their bounds; the dense one twice
     bit for bit;
 16. hetero steps: the fwd+bwd iteration in (density, sigma_s) on
     examples/bench_hetero_bwd.py's scene (128x128, 50k photons, a warm and
     3 timed steps) and one config-3 step at 512x512 x 100k after a warm
     step, each timed run counted (s/step, peak memory, launches);
 17. hetero backward parity: the hetero backward kernels against their
     plain versions on the bench step's sweeps (want_extras both ways) and
     the config-3 step's R/4 sweep, each cotangent against its own
     max|ref|, the d tr_full, d power_end and geometry rows exactly 0, two
     runs bit for bit; timed on the config-3 step's sweeps beside their
     bounds and launched grids, and kernel by kernel as in phase 11;
 18. hetero trainer: optimize_medium, 3 steps with examples/inverse_smoke.py's
     settings (3 views at 64x64, 20k photons, density only, tv_weight 2e-3,
     lr 3e-2), counted;
 19. CUDA against the CPU on a 32x32, 3,000-photon config-3 scene: the image
     and the density and sigma_s gradients.

  The default gather route (gather_beams_bruteforce: what PhotonBeamConfig()
  and the CLI take), through the forward kernels on the non-packed layout,
  the recompute backward with the geometry attached, and the analytic
  backward kernels with it detached, kernel 6 (the two-pass backward) among
  them:
 20. the CLI's config 2: examples/cornell_fog.pbrt read by the port's
     parser, the config cli.photonbeam_config builds from the file
     (256x256, 16 iterations, 65,536 photons, radius 0.15, maxdepth 5,
     alpha 0.5, every other field at its default: gather="auto",
     grad_geometry=True, gather_chunk=2048), no cut; counters set to 0
     before and read after: the forward kernel must launch and the packed
     route must never be called (s/iter, valid beams, image mean); one more
     iteration timed phase by phase (trace, compaction, packing per call,
     the kernel per sweep); the same render on the packed route
     (gather="pallas", grad_geometry=False) must agree (channel means 1e-4
     relative, 99% of pixels within 1e-3); the forward kernel against its
     plain version on this route's largest sweep (the R/4 budget: the
     scene's back and side walls face away from the fog, so only rays
     leaving the floor and the ceiling continue in it, at most a quarter
     of the camera rays);
 21. the CLI's config 3: phase 13's scene at smoke_hetero.pbrt's integrator
     settings (512x512, 100k photons, 8 iterations, radius 0.15, the rest
     at the defaults): the hetero forward kernel must launch, the packed
     route never, and the image must agree with phase 13's as in phase 20;
 22. the geometry-attached step: bench.py's fog box at 128x128 x 50k,
     radius 0.2, the default config (grad_geometry=True, grad_extras=True),
     mean(Ld) and its gradient in sigma_a and sigma_s through the attached
     photon walk and the recompute backward: a warm step (its first
     in-medium gather's inputs kept for phase 23) and 2 timed steps,
     counted (s/step, peak memory); the same step at 32x32 x 4,000 on the
     card and on the CPU;
 23. the analytic backward on the non-packed layout: phase 22's first
     in-medium gather with the geometry detached, fwd+bwd under
     PALLAS_BWD_MODE "fused" and "twopass", counted, each cotangent (ps,
     pe, radius, tr, sigma_s, g, cam_radius) against the recompute
     backward's; kernel 6 against its plain version on the same packed
     inputs, per cotangent, and twice bit for bit;
 24. kernel 6 timed on phase 9's spec-step shapes (R/4: 64 ray tiles, full
     film: 256, x 27,344 chunks) beside its bound and the fused kernels on
     the same inputs (all-ones mask, extras on); against its plain version
     on a slice of the R/4 sweep's chunks;
 25. breadth: gather="brute" (the plain chunk scan, forward and a gradient)
     and rendermedia=False at 64x64 x 20k photons, on the card against the
     CPU.

 Several ranks (torch.distributed; the card is one H100, so NCCL runs one
 rank and two ranks share the card through gloo), and part of the camera
 walk's arithmetic:
 26. NCCL world size 1: phase 9's spec step (fog box, 256x256, 1M photons,
     radius 0.1, gather="auto", geometry detached) as
     make_inverse_train_step's loss mean(Ld^2), through
     initialize_distributed(backend="nccl") with one rank, against the same
     step on the one-device mesh: loss and every gradient bit for bit;
     s/step and peak memory of both, beside the card's name and power
     limit; the NCCL step counted (rows 1 and 3 must launch);
 27. dryrun_multichip: two gloo ranks on the card at
     __graft_entry__.dryrun_multichip's size (16x16, 256 photons, the
     default route) and at bench.py's 128x128 x 50k (geometry detached),
     and one NCCL rank at the graft size, each against the one-device step
     (loss within 1e-4 relative, sigma_a gradient within 1e-3 of its max;
     the one NCCL rank bit for bit), every rank's kernel launches in its
     sharded step (a forward kernel on every rank, and at the bench size a
     backward kernel); times logged as first calls;
 28. index-order dot: every core.math.dot of the intersector and the BSDF
     in a 64x64, 20,000-photon config-2 render, and length_squared of its
     first operand, bit for bit (a0 b0 + a1 b1) + a2 b2 in numpy float32;
     how often the card's sum(-1) differs is logged.

 The CLI (scene input, image output, checkpoint and resume):
 29. (a) cli.main on examples/cornell_fog.pbrt in this process, counted:
     rc 0, the forward kernel launched, the packed route never called, and
     its PFM read back bit for bit phase 20's image (wall time, s/iter);
     (b) cli.main on examples/smoke_hetero.pbrt, counted: the dense hetero
     forward kernel launched, the packed route never, and its image against
     the same parsed scene rendered on the packed route (phase 20's route
     tolerances); the host time of parse_file on the 231 KB file;
     (c) the parsed config 2 rendered to iteration 8 with a checkpoint
     under chiprun_out/, then the full 16-iteration config resumed from it:
     8 iterations run, the image bit for bit phase 20's; (d) python -m
     bre_tpu_torch.cli examples/fog_cube.pbrt --quick in a child process:
     exit 0 and a finite 64x64 PNG.

 The reference-matching path (kernel="compat") and the volpath oracle:
 30. (a) BASELINE config 1 at its full size: cli.main on
     examples/fog_cube.pbrt with --kernel compat (64x64, 8 iterations x
     10,000 photons, maxdepth 5), counted: rc 0, no kernel launched (the
     compat kernel is the plain chunk scan, on the card too), the
     non-packed route called and the packed one never; photon paths
     exactly 80,000, medium interactions, beams stored and each channel
     mean within 2% of the C++ reference's (67,452 / 173,641 / 0.0352,
     0.0311, 0.0271, BASELINE.md); wall time, s/iter and one iteration
     timed as trace and camera pass; the overflowed walks printed; (b) the
     golden gates of tests/test_torch_reference_golden.py (fog_golden.pfm
     at 32x32 x 2 x 2,000, smoke_golden.pfm at 64x64 x 20,000) with their
     assertions; (c) render_volpath on the fog cube (24x24, maxdepth 8 x
     384 spp) against the photon-beam render (24 x 12,000 photons) under
     tests/test_photonbeam_vs_volpath.py's _check tolerances, volpath's
     s/spp; (d) the same on that file's grid smoke (20x20).

 The photon-mapping integrators and the sampled integrators (no kernel
 launches on any of them: the reference runs them as XLA code):
 31. (a) tests/test_torch_vsppm_golden.py's gates at 32 and 64 iterations
     (render_vsppm, kernel="compat", on vsppm_golden.pbrt at 32x32, 2,000
     photons per iteration): the combined medium interactions within 0.5%
     of the C++ reference's 44,273 and 88,525, channel means within 3%,
     4x4 region means within 15% and 10%; (b) cli.main on
     vsppm_golden.pbrt as written (8 iterations) with --kernel compat:
     16,000 photon paths, the combined interactions within 1.5% of 11,073,
     medium and surface visible points within 2% of 3,219 and 4,973; (c)
     vsppm with the physical kernel at config 1's width (fog_cube.pbrt:
     64x64, 8 x 10,000 photons, maxdepth 5, radius 0.25) against
     render_volpath on the same scene (random sampler, uniform pick, 64
     spp): the ratio of means within 0.6-1.6; (d) vsppm at config 2's
     width (cornell_fog.pbrt: 256x256, 65,536 photons per iteration, radius
     0.15, maxdepth 5, 4 iterations): warm s/iter, peak memory, a finite
     image; (e) render_photonmap on tests/test_photonmap.py's fog cube
     (no surfaces) at 64x64 with PhotonMapConfig()'s defaults: no direct or
     caustic photons, the ratio of means against volpath (64 spp) within
     0.5-1.7, s per pass; (f)
     cli.main on fog_cube.pbrt's text with its Integrator renamed volpath,
     then directlighting (its halton sampler, 8 spp, the spatial
     strategy): finite images, volpath's mean within 5% of (c)'s; s/spp.

 Bidirectional path tracing, MLT and the spectral mode (no kernel
 launches: the reference runs them as XLA code):
 32. (a) cli.main on tests/data/bdpt_golden.pbrt as written (32x32, 64
     spp, maxdepth 4): channel means within 1.5% and 4x4 region means
     within 6% of the C++ reference's bdpt_golden.pfm
     (tests/test_torch_bdpt_golden.py's gate); wall s and s/spp; (b) the
     same scene at 256x256 x 16 spp through render_bdpt, twice: the two
     images bit-identical (the sorted-segment splats), s/spp, lanes per
     batch, peak memory; (c) tests/test_bdpt.py's fog shell lit by a
     small sphere light at 64x64, bdpt (16 spp, maxdepth 5) against
     volpath (64 spp, maxdepth 6): means within 10%; (d) render_mlt on
     tests/test_mlt.py's lit sphere at 64x64 with the reference's 256
     chains, 4,096 bootstrap samples and 16 mutations per pixel (maxdepth
     5): the mean within 0.97 +- 0.06, s per chain step; cli.main on the
     golden scene's text as mlt with --quick; (e) render_volpath_spectral
     on tests/test_spectral.py's gray fog at 64x64 x 16 spp (stratified,
     maxdepth 4): the ratio of means to the RGB render within 2%, the
     time of each.

 The sparse tier in its regime (rows 2 and 4 where gather="auto" picks them):
 33. config 2's full-film sweep (one iteration's camera segments and beams)
     with its block mask recomputed at the radii of the reference's alpha
     = 0.5 schedule at iterations 1, 16, 64 and 256 (config 2's own alpha,
     0.7, beside it): the live share of the block grid at each, and the
     first of these iterations at which the default cap picks the sparse
     kernel ("none" if it never does); at the first radius whose sweep is
     at most a quarter live (bench.py's fog box if config 2's never is),
     rows 2 and 4 (want_extras both ways, ct from a seed) against rows 1
     and 3 on the same mask, CUDA events, mean of 3 after a warm-up, beside
     the bound of the listed blocks, dense and sparse bit for bit, each
     twice bit for bit; the work per launched block (listed tiles per
     chunk, listed chunks per run) with the modelled tail of launching in
     index and in work order; the sparse kernels against their plain
     versions on the sweep's heaviest and a median ray tile; the sparse and
     dense backward's kernels one by one under torch.profiler (a child).

The surface materials and the texture table (plain torch: the reference
runs them as XLA code; config 4's gathers go through rows 1-2):
 34. (a) BASELINE config 4 through cli.main on examples/glass_caustics.pbrt
     as written (256x256, 12 iterations x 100,000 photons, maxdepth 6,
     the default route), counted: the forward kernels must launch and the
     image be finite; wall s, s/iter, the photon statistics, and the same
     config through render_photonbeam with each iteration timed; (b) the
     8-iteration caustics golden gate (interactions within 0.2% of the C++
     reference's 111,394, channel means within 1.5%, region p90 under 0.12
     and max under 0.5); (c) every material's sample_bsdf (both modes)
     and eval_bsdf at 2^20 lanes (the textured ones at 2^16) on the card
     against the CPU, within rtol 1e-5 plus four times the CPU's own
     spread under 1-8 ulp input moves; (d) volpath with texture_filter=True
     on image maps at 64x64 x 4 spp, card against CPU (means within 1e-3);
     (e) render_mlt (a CUDA-graph chain step) on the glass, mirror, metal
     and plastic scene: a finite image.  Prints its own seconds.

Prints, before the last line, one JSON line with each kernel's launches
(phase 3 for the forward kernels, phase 9's counted run for the backward
ones, phases 13, 14 and 16's config-3 step for the hetero instances,
phase 23 for kernel 6; rows 1 and 3 also count their launches on the
non-packed route, phases 20 and 23, and rows 1 and 5 their launches by
the CLI, phase 29 (a) and (b), as launches_cli), max abs error (and, for
the backward kernels, max |diff| / max|ref| per cotangent), time beside
its plain version's and its bound, and the
splits per ray tile and blocks that its wrapper launched on its headline
sweep (row 1's is the config-2 R/4 sweep, row 3's the spec step's;
``beam_blocks`` is the backward's d_beams grid); rows 2 and 4 also carry
``regime``, their phase-33 figures (ms, bound, share, the dense row's ms
on the same mask, the iteration, radius and live share); the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.  Details go to chiprun_out/chip_smoke.json.  Exits nonzero
without a card.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from bre_tpu_torch import cli as CLI  # noqa: E402
from bre_tpu_torch import materials as MAT  # noqa: E402
from bre_tpu_torch.accel import beam_gather as BG  # noqa: E402
from bre_tpu_torch.core import math as CMATH  # noqa: E402
from bre_tpu_torch.core import transform as tfm  # noqa: E402
from bre_tpu_torch.integrators import inverse as INV  # noqa: E402
from bre_tpu_torch.integrators import photonbeam as PB  # noqa: E402
from bre_tpu_torch.integrators.photon_trace import trace_photon_beams  # noqa: E402
from bre_tpu_torch.io import image as IMG  # noqa: E402
from bre_tpu_torch.lights import light_power_distribution  # noqa: E402
from bre_tpu_torch.ops import cuda_build  # noqa: E402
from bre_tpu_torch.ops import gather as G  # noqa: E402
from bre_tpu_torch.ops import gather_bwd as GB  # noqa: E402
from bre_tpu_torch.parallel import dryrun as DRYRUN  # noqa: E402
from bre_tpu_torch.parallel import mesh as MESH  # noqa: E402
from bre_tpu_torch.scene import intersect as ISECT  # noqa: E402
from bre_tpu_torch.scene import parser as PARSER  # noqa: E402
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
# the grid-density (heterogeneous) instances of the same wrappers, counted
# in their launches_het
HET_KERNELS = (
    ("gather_forward_het", G, "bre_tpu/ops/pallas_gather.py:245", FWD_SOURCE),
    ("gather_sparse_het", G, "bre_tpu/ops/pallas_gather.py:425", FWD_SOURCE),
    ("gather_backward_fused_het", GB, "bre_tpu/ops/pallas_gather_bwd.py:241",
     BWD_SOURCE),
)
HET_FWD_KERNELS = HET_KERNELS[:2]
# kernel 6, the two-pass backward of the non-packed route (PALLAS_BWD_MODE
# "twopass")
TWOPASS_KERNELS = (
    ("gather_backward_twopass", GB, "bre_tpu/ops/pallas_gather_bwd.py:775",
     BWD_SOURCE),
)
# the gather routes, each counting its calls
ROUTES = ("gather_beams_bruteforce", "gather_beams_packed")
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
# grid media (the HETERO instances): every in-range pair, forward: cos,
# phase, kernel and 1/sin as above (28 FP32 + 2 rsqrt), the tables by Horner
# with their clamps at 0 (dens 11, D_b 10, D_c 10), and per channel the
# decay and the product (9 FP32 + 1 exp each)
FWD_IN_OPS_HET = 30 + 31 + 30
# backward: the weights (31) and tables (31) once, per channel the d_rays
# terms (22 FP32 + 1 exp each) and the d_beams terms (6 each), the D_c, dens
# and D_b coefficient chains (36 + 17); the extras' weight derivatives (22)
# and per channel d g, d cam_radius and d radius (15 each)
BWD_IN_OPS_HET = 31 + 31 + 3 * (23 + 6) + 36 + 17
BWD_EXTRAS_OPS_HET = 22 + 3 * 15


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


def ptxas_summary(build_log):
    """{kernel instance: registers, shared memory and spill bytes} from
    nvcc's -Xptxas -v report of the build (empty when the library was
    already built)."""
    out, name, spill = {}, None, ""
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = _demangle(line.split("Function properties for ")[-1].strip())
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out[name] = f"{line.split(':', 1)[-1].strip()}; {spill}"
            name, spill = None, ""
    return out


def _demangle(mangled):
    """gather_dense_kernel<true> style names of the kernels' instances; the
    beam pre-pass and reduce_splits, compiled into both sources, carry the
    source's tag."""
    m = re.search(r"(gather_dense_kernel|gather_sparse_kernel|bwd_rays_dense|"
                  r"bwd_beams_dense|bwd_rays_sparse|bwd_beams_sparse|"
                  r"stage_beams)I(.*)E", mangled)
    if m:
        args = ["true" if b == "1" else "false"
                for b in re.findall(r"Lb([01])E", m.group(2))]
        name = f"{m.group(1)}<{', '.join(args)}>"
    else:
        plain = re.search(r"(stage_power_chunks|flagged_extent|"
                          r"reduce_splits)", mangled)
        if not plain:
            return mangled
        name = plain.group(1)
    if name.startswith(("stage_beams", "reduce_splits")):
        name += " (fwd)" if "beam_gather_fwd" in mangled else " (bwd)"
    return name


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


def _counter(name, mod):
    """(wrapper, attribute) of a kernel's launch count: a heterogeneous
    instance counts on its wrapper's ``launches_het``."""
    if name.endswith("_het"):
        return getattr(mod, name[:-len("_het")]), "launches_het"
    return getattr(mod, name), "launches"


def launches(kernels=KERNELS):
    return {name: getattr(*_counter(name, mod)) for name, mod, _, _ in kernels}


def reset_launches():
    for name, mod, _, _ in KERNELS + HET_KERNELS + TWOPASS_KERNELS:
        setattr(*_counter(name, mod), 0)
    for name in ROUTES:
        getattr(BG, name).calls = 0


def route_calls():
    return {name: getattr(BG, name).calls for name in ROUTES}


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
    cfg = PB.PhotonBeamConfig(
        iterations=iters, maxdepth=MAXDEPTH, photonsperiteration=photons,
        initialbeamradius=0.12, alpha=0.7, gather="auto",
        grad_geometry=False, imagewritefrequency=1, **over)
    return timed_render(cornell_fog(dev), cornell_camera(dev, size), size,
                        cfg)


def timed_render(scene, cam, size, cfg, checkpoint_path=None):
    """render_photonbeam with the host clock read at each write point
    (every iteration at imagewritefrequency 1; each ends in a copy of the
    image to the host): (image on the host, stats, s per write point)."""
    marks = []
    t0 = time.perf_counter()
    img, stats = PB.render_photonbeam(
        scene, cam, size, size, cfg,
        write_callback=lambda it, im: marks.append(time.perf_counter()),
        checkpoint_path=checkpoint_path)
    if scene.device.type == "cuda":
        torch.cuda.synchronize()
    return img.float().cpu(), stats, np.diff([t0] + marks).tolist()


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


def launched_grid(wrapper):
    """The grid of ``wrapper``'s last launch as the wrapper passed it to
    its kernels: splits per ray tile, ray-side blocks and, for the
    backward, d_beams blocks."""
    grid = wrapper.last_grid
    out = dict(n_splits=grid[1], blocks=grid[0] * grid[1])
    if len(grid) > 2:
        out["beam_blocks"] = grid[2]
    return out


# each backward wrapper's kernel launches per call, in order
# (csrc/beam_gather_bwd.cu launch_dense, launch_sparse, launch_twopass)
WRAPPER_LAUNCHES = {
    "gather_backward_fused": ("stage_beams", "bwd_rays_dense",
                              "reduce_splits", "bwd_beams_dense"),
    "gather_backward_sparse": ("stage_beams", "bwd_rays_sparse",
                               "reduce_splits", "bwd_beams_sparse"),
    "gather_backward_twopass": ("stage_power_chunks", "flagged_extent",
                                "bwd_rays_dense", "reduce_splits",
                                "bwd_beams_dense"),
}
PROFILE_REPS = 3


def backward_kernel_ms(cases):
    """{label: {kernel: device ms}}: each kernel launch of a wrapper
    (WRAPPER_LAUNCHES; the dense backward's: the beam pre-pass, the d_rays
    sweep, the split reduction, the d_beams sweep) on each case, the mean
    of PROFILE_REPS calls, from one torch.profiler run in a child process
    (``chip_smoke.py --profile-backward FILE``): a process records kernels
    in its first profiler run only.  A case is (wrapper name, arguments)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cases.pt")
        torch.save(cases, path)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--profile-backward",
             path], capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"the kernels' profile failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def profile_backward(path):
    """The child of backward_kernel_ms: prints its result as one JSON line."""
    from torch.profiler import ProfilerActivity, profile
    cases = torch.load(path)
    for name, args in cases.values():  # warm-up
        getattr(GB, name)(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, args in cases.values():
            for _ in range(PROFILE_REPS):
                getattr(GB, name)(*args)
        torch.cuda.synchronize()
    known = sorted({k for v in WRAPPER_LAUNCHES.values() for k in v})
    pat = re.compile(r"\b(" + "|".join(known) + r")\b")
    found = sorted(((e.time_range.start, e.time_range.end, m.group(1))
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and (m := pat.search(e.name))))
    want = [k for name, _ in cases.values()
            for k in WRAPPER_LAUNCHES[name] * PROFILE_REPS]
    names = [k for _, _, k in found]
    if names != want:
        raise AssertionError(f"the profile holds {len(found)} kernel "
                             f"launches, not the {len(want)} expected: "
                             f"{names[:8]}")
    out, pos = {}, 0
    for label, (name, _) in cases.items():
        seq = WRAPPER_LAUNCHES[name]
        n = len(seq)
        runs = found[pos:pos + n * PROFILE_REPS]
        pos += n * PROFILE_REPS
        out[label] = {k: sum((e - s) / 1e3 for s, e, _ in runs[i::n])
                      / PROFILE_REPS for i, k in enumerate(seq)}
    print(json.dumps(out), flush=True)


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


def fwd_sweep_check(names, rays, beams, scal, mask, in_ops, label, tag,
                    note=""):
    """Both forward kernels (``names``: the dense and the sparse entry of a
    kernel table) against their plain versions on one sweep's inputs, rtol
    2e-4 / atol 1e-8, each timed with CUDA events after a warm-up beside
    its bound (``in_ops`` per in-range pair); dense and sparse must agree
    bit for bit.  Returns {name: measurements}."""
    n_live = int((mask > 0).sum())
    idx, _ = G.sparse_block_ids(mask, n_live)
    idx1, _ = G.sparse_block_ids(mask[:, :1].contiguous(), mask.shape[0])
    in_range, n_blocks = pairs_in_range(rays, beams, scal, mask)
    ops = n_blocks * BG.TILE * BG.CHUNK * GEOM_OPS + in_range * in_ops
    out_bytes = rays.shape[0] * G.OUT_ROWS * BG.TILE * 4
    out, outs = {}, []
    for name, wrapper, kern, plain, warm, inputs in zip(
            names, (G.gather_forward, G.gather_sparse), (
            lambda: G.gather_forward(rays, beams, scal, mask),
            lambda: G.gather_sparse(rays, beams, scal, idx)), (
            lambda: G.gather_forward_ref(rays, beams, scal, mask),
            lambda: G.gather_sparse_ref(rays, beams, scal, idx)), (
            lambda: G.gather_forward_ref(rays[:1], beams, scal, mask[:, :1]),
            lambda: G.gather_sparse_ref(rays[:1], beams, scal, idx1)), (
            (rays, beams, scal, mask), (rays, beams, scal, idx))):
        res = kern()
        if name == names[0]:  # the dense kernel: the same bits twice
            if not torch.equal(res, kern()):
                raise AssertionError(f"{name} ({label}): two runs differ")
            log(f"[{tag}] {label}: {name} two runs bit-identical")
        torch.cuda.synchronize()
        warm()
        plain_ms, ref = cuda_ms(plain, 1, warm=False)
        if not bool(torch.isfinite(res).all()):
            raise AssertionError(f"{name} ({label}): non-finite output")
        abs_err = float((res - ref).abs().max())
        rel_err = float(((res - ref).abs() / (ref.abs() + ATOL)).max())
        ok = bool(torch.allclose(res, ref, rtol=RTOL, atol=ATOL))
        ms, _ = cuda_ms(kern, 3)
        grid = launched_grid(wrapper)
        bound_ms, bound_by = bound(ops, nbytes(*inputs) + out_bytes)
        log(f"[{tag}] {label}, {n_live} live blocks, {in_range} pairs in "
            f"range: {name} max rel err {rel_err:.3e} max abs err "
            f"{abs_err:.3e} (|ref| max {float(ref.abs().max()):.3e}) "
            f"allclose(rtol={RTOL}, atol={ATOL}) {ok}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); "
            f"launched {grid['n_splits']} splits x {rays.shape[0]} ray tiles "
            f"= {grid['blocks']} blocks" + note)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on the {label} sweep")
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=abs_err,
                         max_rel_err=rel_err, live_blocks=n_live,
                         pairs_in_range=in_range, bound_ms=bound_ms,
                         bound_by=bound_by, **grid)
        outs.append(res)
        del ref
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"dense and sparse kernels differ on the "
                             f"{label} sweep's live blocks")
    log(f"[{tag}] {label}: dense and sparse kernels agree bit for bit")
    return out


def _kernel_rows(kernels):
    return {name: dict(name=name, route="cuda", source=src, replaces=rep,
                       max_abs_err=0.0, max_rel_err=0.0, sweeps={},
                       library_ms=None)
            for name, _, rep, src in kernels}


def _add_sweep(results, checked, label, headline):
    """Fold one sweep's measurements into the kernels' rows; the headline
    sweep's times are the rows' own."""
    for name, m in checked.items():
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], m["max_abs_err"])
        r["max_rel_err"] = max(r["max_rel_err"], m["max_rel_err"])
        r["sweeps"][label] = m
        if headline:
            r.update(ms=m["ms"], plain_ms=m["plain_ms"],
                     bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                     sweep=headline, n_splits=m["n_splits"],
                     blocks=m["blocks"])


def phase_parity(sweeps):
    results = _kernel_rows(FWD_KERNELS)
    for label in ("full", "r4"):
        rays, beams, scal, mask = sweeps[label]
        log(f"[parity] {label} sweep: rays {tuple(rays.shape)} beams "
            f"{tuple(beams.shape)} ({-(-int(scal[0, 3]) // BG.CHUNK)} chunks "
            f"hold valid beams), {mask.numel()} blocks")
        checked = fwd_sweep_check([n for n, _, _, _ in FWD_KERNELS], rays,
                                  beams, scal, mask, FWD_IN_OPS, label,
                                  "parity")
        # the dense kernel's headline is the R/4 sweep (64 ray tiles, where
        # the split matters most); the sparse one launches at full film
        for name, m in checked.items():
            head = {("gather_forward", "r4"): "config-2 R/4 budget",
                    ("gather_sparse", "full"): "config-2 full film"}
            _add_sweep(results, {name: m}, label, head.get((name, label)))
    return list(results.values())


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
    """bench.py's iteration: mean(Ld) of one iteration and its gradient in
    ``params``; the photon sampling is detached where the gather geometry
    is (``grad_geometry=False``), as render_photonbeam does."""
    leaves = {k: getattr(scene.media, k).detach().clone().requires_grad_()
              for k in params}
    sc = scene._replace(media=scene.media._replace(**leaves))
    photons, radius = cfg.photonsperiteration, cfg.initialbeamradius
    beams, _ = trace_photon_beams(sc, light_power_distribution(sc), iter_idx,
                                  photons, cfg.maxdepth, radius,
                                  detach_sampling=not cfg.grad_geometry)
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
        scene, cam, SIZE, SIZE, cfg, None, light_power_distribution(scene))
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


def _bwd_close(out, ref, what, het=False):
    """Each cotangent (its rows of d_rays or d_beams, gather_bwd.D_RAYS_ROWS
    and D_BEAMS_ROWS, or their _HET forms) held to the criterion against its
    own max|ref|, so the large d sigma_s and d power rows cannot hide the
    small d tr, d g and d radius rows; the other rows of d_beams (and, in
    grid media, the d tr_full rows of d_rays) must be exactly zero.
    Returns {cotangent: (max |diff|, max |diff| / (max|ref| + 1e-9))}."""
    rows_r, rows_b = ((GB.D_RAYS_ROWS_HET, GB.D_BEAMS_ROWS_HET) if het
                      else (GB.D_RAYS_ROWS, GB.D_BEAMS_ROWS))
    errs = {}
    for o, r, part, rows in zip(out, ref, ("d_rays", "d_beams"),
                                (rows_r, rows_b)):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{what}: non-finite {part}")
        for name, sl in rows.items():
            err = float((o[:, sl] - r[:, sl]).abs().max())
            r_max = float(r[:, sl].abs().max())
            if not err <= BWD_RTOL * (r_max + 1e-9):
                raise AssertionError(f"{what}: d {name} max |diff| {err}, "
                                     f"max |ref| {r_max}")
            errs[name] = (err, err / (r_max + 1e-9))
    other = torch.ones(out[1].shape[1], dtype=torch.bool, device=out[1].device)
    for sl in rows_b.values():
        other[sl] = False
    zero = [float(out[1][:, other].abs().max())]
    if het:
        zero.append(float(out[0][:, GB.DR_TR:GB.DR_TR + 3].abs().max()))
    if any(z != 0.0 for z in zero):
        raise AssertionError(f"{what}: rows that must be 0 are not: {zero}")
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
        if not all(torch.equal(a, b) for a, b in zip(outs[0], dense())):
            raise AssertionError(f"gather_backward_fused: two runs differ on "
                                 f"the {label} sweep")
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
        log(f"[bwd parity] {label}: dense and sparse agree bit for bit; the "
            f"dense kernel's two runs bit-identical")
    profiled = {}
    for label in ("r4", "full"):
        args = spec_sweeps[label]
        extras = args[6]
        dense, sparse, _, inputs, n_live = _bwd_case(args, extras)
        bounds, in_range = _bwd_bound(args, inputs, extras)
        for name, fn, wrapper in zip(names, (dense, sparse), (
                GB.gather_backward_fused, GB.gather_backward_sparse)):
            ms, _ = cuda_ms(fn, 3)
            grid = launched_grid(wrapper)
            bound_ms, bound_by = bounds[name]
            gpairs = n_live * BG.TILE * BG.CHUNK / ms / 1e6
            results[name]["sweeps"][f"spec {label} timing"] = dict(
                ms=ms, live_blocks=n_live, gpairs_s=gpairs,
                pairs_in_range=in_range, bound_ms=bound_ms,
                bound_by=bound_by, **grid)
            if label == "r4":
                results[name].update(ms=ms, bound_ms=bound_ms,
                                     bound_by=bound_by, **grid)
            log(f"[bwd timing] spec {label} sweep ({args[1].shape[0]} ray "
                f"tiles x {args[0].shape[0]} chunks, {n_live} live blocks, "
                f"{in_range} pairs in range): {name} {ms:.3f} ms, "
                f"{gpairs:.1f} Gpairs/s, bound {bound_ms:.3f} ms "
                f"({bound_by}); launched {grid['n_splits']} splits x "
                f"{args[1].shape[0]} ray tiles = {grid['blocks']} d_rays "
                f"blocks, {grid['beam_blocks']} d_beams blocks"
                + ("" if label == "r4" else "; plain version not run at "
                   "full film (minutes)"))
        profiled[label] = ("gather_backward_fused",
                           (*inputs["gather_backward_fused"], extras))
    for label, parts in backward_kernel_ms(profiled).items():
        results[names[0]]["sweeps"][f"spec {label} timing"]["kernels_ms"] = parts
        log(f"[bwd kernels] spec {label} sweep, gather_backward_fused, device "
            f"ms per kernel (torch.profiler, mean of {PROFILE_REPS}): "
            + json.dumps({k: round(v, 3) for k, v in parts.items()}))
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



# ---------------------------------------------------------------------------
# Grid-density media (phases 13-19): the config-3 render and the density
# gradient, through the heterogeneous instances of the kernels
# ---------------------------------------------------------------------------

SMOKE_SIZE, SMOKE_PHOTONS, SMOKE_ITERS = 512, 100_000, 8  # BASELINE config 3
HBENCH_WH, HBENCH_PHOTONS = 128, 50_000  # examples/bench_hetero_bwd.py
INV_WH, INV_PHOTONS, INV_TARGET_ITERS = 64, 20_000, 4  # examples/inverse_smoke.py
SMOKE_W2M = np.array([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5], [0, 0, 0.5, 0.5],
                      [0, 0, 0, 1]], np.float32)  # world [-1,1]^3 -> [0,1]^3
SMOKE_LOOKS = (((0, 0, -3.2), (0, 0, 0), (0, 1, 0)),
               ((3.0, 0.4, -1.2), (0, 0, 0), (0, 1, 0)),
               ((-1.6, 2.6, -1.6), (0, 0, 0), (0, 1, 0)))
# the plain forward is held on every 4th ray tile of a sweep with more live
# blocks than this (a full-film plain sweep would take minutes)
PLAIN_MAX_LIVE = 400_000


def smoke_density(n=32):
    """examples/smoke_hetero.py:38-43: an elongated puff with swirls."""
    x, y, z = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    d = np.exp(-2.0 * (x**2 + 2 * y**2 + z**2))
    d *= 1.0 + 0.5 * np.sin(4 * x) * np.cos(3 * z)
    return np.clip(d, 0.0, None).astype(np.float32)


def smoke_scene(dev, density=None, g=0.4):
    """examples/smoke_hetero.py:45-56 (BASELINE config 3): the grid smoke
    in [-1,1]^3 lit from inside, a wall behind it."""
    b = SceneBuilder()
    smoke = b.grid_medium(smoke_density() if density is None else density,
                          SMOKE_W2M, sigma_a=(0.02,) * 3, sigma_s=(0.6,) * 3,
                          g=g)
    wall = b.matte((0.5, 0.5, 0.6))
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=smoke,
          medium_outside=-1)
    b.quad((-4, -4, 2.5), (-4, 4, 2.5), (4, 4, 2.5), (4, -4, 2.5),
           material=wall)
    b.point_light((0.0, 0.8, -0.5), (2.0, 1.9, 1.7), medium=smoke)
    return b.build(device=dev)


def smoke_camera(dev, size, look=SMOKE_LOOKS[0]):
    return make_perspective_camera(tfm.look_at(*look), 50.0, size, size,
                                   device=dev)


def smoke_cfg(photons, radius=0.15, **over):
    """examples/smoke_hetero.py:59-62's settings."""
    return PB.PhotonBeamConfig(
        maxdepth=MAXDEPTH, photonsperiteration=photons,
        initialbeamradius=radius, gather="pallas", grad_geometry=False,
        grad_extras=False, **over)


def render_smoke(dev, size, photons, iters, **over):
    return timed_render(smoke_scene(dev), smoke_camera(dev, size), size,
                        smoke_cfg(photons, iterations=iters,
                                  imagewritefrequency=1, **over))


def smoke_grid_cap(size, photons):
    """gather_sparse_cap at the block grid: every full-film sweep fits."""
    return (-(-photons * (MAXDEPTH + 2) // BG.CHUNK)) * (size * size // BG.TILE)


def phase_smoke_render(dev):
    """(a) BASELINE config 3 through SceneBuilder.grid_medium and
    render_photonbeam, the counters set to 0 just before and read after."""
    reset_launches()
    img, stats, per_iter = render_smoke(dev, SMOKE_SIZE, SMOKE_PHOTONS,
                                        SMOKE_ITERS)
    counts = launches(FWD_KERNELS + HET_FWD_KERNELS)
    mean = check_image(img, SMOKE_SIZE, "config-3 render")
    warm = float(np.mean(per_iter[1:]))
    log(f"[smoke] config 3: {SMOKE_SIZE}x{SMOKE_SIZE}, {SMOKE_PHOTONS} "
        f"photons/iter, {SMOKE_ITERS} iters, maxdepth {MAXDEPTH}, radius "
        f"0.15, g 0.4, 32^3 grid, gather=pallas: s/iter {per_iter} (warm, "
        f"iterations 2-{SMOKE_ITERS}: {warm:.4f}); valid beams/iter "
        f"{stats['n_beams'] / SMOKE_ITERS:.0f}; grid-tracking overflow "
        f"{stats['n_grid_overflow']}; image mean {mean:.6f}, finite; "
        f"launches {counts}")
    if counts["gather_forward_het"] <= 0 or counts["gather_forward"] != 0:
        raise AssertionError(f"config 3 must run the dense hetero kernel and "
                             f"no homogeneous one: {counts}")
    return img, dict(per_iter_s=per_iter, warm_s_per_iter=warm,
                     image_mean=mean, n_beams_per_iter=stats["n_beams"]
                     / SMOKE_ITERS, n_grid_overflow=stats["n_grid_overflow"],
                     launches=counts)


def phase_smoke_counted(dev, img_main):
    """(b) the same render with the sparse cap at the block grid: the
    full-film sweeps take the sparse hetero kernel; same image bit for
    bit."""
    grid = smoke_grid_cap(SMOKE_SIZE, SMOKE_PHOTONS)
    reset_launches()
    img, stats, per_iter = render_smoke(dev, SMOKE_SIZE, SMOKE_PHOTONS,
                                        SMOKE_ITERS, gather_sparse_cap=grid)
    counts = launches(FWD_KERNELS + HET_FWD_KERNELS)
    identical = torch.equal(img, img_main)
    log(f"[smoke counted] gather_sparse_cap={grid} (the block grid): s/iter "
        f"{per_iter}; launches {counts}; image bit-identical to the dense "
        f"run {identical} (max |diff| "
        f"{float((img - img_main).abs().max()):.3e})")
    if counts["gather_sparse_het"] <= 0:
        raise AssertionError(f"the counted run never launched the sparse "
                             f"hetero kernel: {counts}")
    if not identical:
        raise AssertionError("config-3 sparse-cap render differs from the "
                             "dense one")
    return dict(per_iter_s=per_iter, sparse_cap=grid, launches=counts,
                bit_identical=identical)


def phase_smoke_parity(dev):
    """(c) one more config-3 iteration, timed phase by phase with each
    forward launch recorded; both hetero forward kernels against their
    plain versions on each distinct sweep, timed beside their bounds."""
    sweeps, phases = [], []
    saved = [(BG, n, _event_timed(BG, n, sweeps))
             for n in ("gather_forward", "gather_sparse")]
    saved += [(PB, n, _host_timed(PB, n, phases)) for n in
              ("trace_photon_beams", "medium_interval_poly",
               "pack_beams_compact", "camera_pass")]
    try:
        _, _, per_iter = render_smoke(dev, SMOKE_SIZE, SMOKE_PHOTONS, 1,
                                      startiteration=1, enditeration=2)
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)
    torch.cuda.synchronize()
    log(f"[smoke breakdown] config 3, iteration 2: {per_iter[0]:.4f} s; "
        + ", ".join(f"{n} {t:.4f} s" for n, t in phases) + "; gathers "
        + ", ".join(f"{n} {a[0].shape[0]} tiles {e0.elapsed_time(e1):.3f} ms"
                    for n, e0, e1, a in sweeps))
    keep = {}
    for name, e0, e1, args in sweeps:
        if name == "gather_forward" and args[0].shape[0] not in keep:
            keep[args[0].shape[0]] = (args, e0.elapsed_time(e1))
    results = _kernel_rows(HET_FWD_KERNELS)
    for n_tiles in sorted(keep, reverse=True):
        (rays, beams, scal, mask), render_ms = keep[n_tiles]
        which = "all tiles"
        if int((mask > 0).sum()) > PLAIN_MAX_LIVE:
            rays, mask = rays[::4].contiguous(), mask[:, ::4].contiguous()
            which = "every 4th ray tile"
        label = f"{n_tiles} tiles ({which})"
        checked = fwd_sweep_check(
            [n for n, _, _, _ in HET_FWD_KERNELS], rays, beams, scal, mask,
            FWD_IN_OPS_HET, label, "smoke parity",
            f"; in the render {render_ms:.3f} ms over all {n_tiles} tiles")
        for m in checked.values():
            m["render_dense_ms_all_tiles"] = render_ms
        _add_sweep(results, checked, label, f"config-3 {label}"
                   if n_tiles == max(keep) else None)
    return list(results.values())


def fwd_bwd_smoke(scene, cam, wh, cfg, iter_idx):
    return fwd_bwd(scene, cam, wh, cfg, iter_idx,
                   params=("density", "sigma_s"))


def timed_smoke_step(*args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = fwd_bwd_smoke(*args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, loss, grads


def phase_smoke_steps(dev):
    """(d) fwd+bwd steps in (density, sigma_s): bench_hetero_bwd.py's scene
    at 128x128 / 50k photons (a warm step, 3 timed), then one config-3 step
    at 512x512 / 100k after a warm step; each timed run counted."""
    out, sweeps = {}, {}
    for label, wh, photons, n_timed in (
            ("bench", HBENCH_WH, HBENCH_PHOTONS, 3),
            ("config3", SMOKE_SIZE, SMOKE_PHOTONS, 1)):
        scene, cam, cfg = smoke_scene(dev), smoke_camera(dev, wh), \
            smoke_cfg(photons)
        (t_warm, _, _), rec = capture_backward(
            lambda: timed_smoke_step(scene, cam, wh, cfg, 0))
        sweeps[label] = rec
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        steps = [timed_smoke_step(scene, cam, wh, cfg, it)
                 for it in range(1, n_timed + 1)]
        counts = launches(KERNELS + HET_KERNELS)
        peak = torch.cuda.max_memory_allocated(dev)
        for _, loss, grads in steps:
            if not np.isfinite(loss):
                raise AssertionError(f"{label} step: loss {loss}")
            check_grads(grads, f"{label} hetero step")
        per_step = [t for t, _, _ in steps]
        g = steps[-1][2]
        log(f"[smoke step] {label}: {wh}x{wh}, {photons} photons, maxdepth "
            f"{MAXDEPTH}, radius 0.15, 32^3 grid, grad_extras=False, d/d "
            f"(density, sigma_s): warm step {t_warm:.4f} s, s/step "
            f"{per_step} (mean {np.mean(per_step):.4f}), peak memory "
            f"{peak / 2**30:.3f} GiB; value {steps[-1][1]:.6e}; d sigma_s "
            f"{fmt_values({'s': g['sigma_s']})['s']}, d density max "
            f"{float(g['density'].abs().max()):.4e} on "
            f"{int((g['density'] != 0).sum())} voxels; launches {counts}; "
            f"backward sweeps {[a[1].shape[0] for a in rec]} ray tiles")
        need = ("gather_forward_het", "gather_backward_fused_het")
        if any(counts[k] <= 0 for k in need) or counts["gather_forward"]:
            raise AssertionError(f"{label} step: hetero kernels {need} must "
                                 f"launch, homogeneous ones not: {counts}")
        out[label] = dict(warm_s=t_warm, per_step_s=per_step,
                          peak_memory_bytes=peak,
                          values=[s[1] for s in steps], launches=counts,
                          grads_sigma_s=fmt_values({"s": g["sigma_s"]})["s"])
    return out, sweeps


def phase_smoke_bwd_parity(sweeps):
    """(e) the hetero backward kernels against their plain versions on the
    bench step's sweeps (want_extras both ways) and the config-3 step's
    R/4 sweep; timed on the config-3 step's sweeps beside their bounds."""
    name, _, rep, src = HET_KERNELS[2]
    r = dict(name=name, route="cuda", source=src, replaces=rep,
             max_abs_err=0.0, sweeps={}, library_ms=None, err_over_max_ref={})
    by_tiles = {}
    for a in sweeps["config3"]:
        by_tiles.setdefault(a[1].shape[0], a)
    r4_tiles = SMOKE_SIZE * SMOKE_SIZE // 4 // BG.TILE
    cases = [(f"bench {a[1].shape[0]} tiles #{i}", a, extras)
             for i, a in enumerate(sweeps["bench"]) for extras in (False, True)]
    if r4_tiles in by_tiles:
        cases.append((f"config3 {r4_tiles} tiles", by_tiles[r4_tiles],
                      by_tiles[r4_tiles][6]))
    for label, args, extras in cases:
        beams, rays, scal, mask, ct = args[:5]
        ct_p = BG.pack_ct(ct, rays.shape[0])
        out = GB.gather_backward_fused(rays, beams, scal, ct_p, mask, extras)
        torch.cuda.synchronize()
        plain_ms, ref = cuda_ms(lambda: GB.gather_backward_fused_ref(
            rays, beams, scal, ct_p, mask, extras), 1, warm=False)
        errs = _bwd_close(out, ref, f"{name} ({label})", het=True)
        if not all(torch.equal(a, b) for a, b in zip(
                out, GB.gather_backward_fused(rays, beams, scal, ct_p, mask,
                                              extras))):
            raise AssertionError(f"{name} ({label}): two runs differ")
        r["max_abs_err"] = max([r["max_abs_err"]]
                               + [e for e, _ in errs.values()])
        for k, (_, rel) in errs.items():
            r["err_over_max_ref"][k] = max(r["err_over_max_ref"].get(k, 0.0),
                                           rel)
        n_live = int((mask > 0).sum())
        r["sweeps"][f"{label} extras={extras}"] = dict(
            plain_ms=plain_ms, live_blocks=n_live,
            err_over_max_ref={k: rel for k, (_, rel) in errs.items()})
        if label.startswith("config3"):
            r["plain_ms"] = plain_ms
        log(f"[smoke bwd parity] {label} ({n_live} live blocks, "
            f"want_extras={extras}) {name}: plain {plain_ms:.3f} ms; per "
            f"cotangent max |diff| / max|ref| "
            + json.dumps({k: float(f"{v:.3e}") for k, (_, v) in errs.items()})
            + "; d tr_full, d power_end and geometry rows exactly 0; two "
            "runs bit-identical")
        del ref
    profiled = {}
    for n_tiles, args in sorted(by_tiles.items(), reverse=True):
        beams, rays, scal, mask, ct = args[:5]
        extras = args[6]
        ct_p = BG.pack_ct(ct, rays.shape[0])
        case = (rays, beams, scal, ct_p, mask, extras)
        profiled[str(n_tiles)] = ("gather_backward_fused", case)
        ms, _ = cuda_ms(lambda: GB.gather_backward_fused(*case), 3)
        grid = launched_grid(GB.gather_backward_fused)
        in_range, n_blocks = pairs_in_range(rays, beams, scal, mask)
        ops = (n_blocks * BG.TILE * BG.CHUNK * GEOM_OPS + in_range
               * (BWD_IN_OPS_HET + (BWD_EXTRAS_OPS_HET if extras else 0)))
        n_bytes = nbytes(rays, beams, scal, ct_p, mask, rays[:, :GB.NDR_HET],
                         beams)
        bound_ms, bound_by = bound(ops, n_bytes)
        n_live = int((mask > 0).sum())
        r["sweeps"][f"config3 {n_tiles} tiles timing"] = dict(
            ms=ms, live_blocks=n_live, pairs_in_range=in_range,
            bound_ms=bound_ms, bound_by=bound_by,
            gpairs_s=n_live * BG.TILE * BG.CHUNK / ms / 1e6, **grid)
        if n_tiles == r4_tiles or "ms" not in r:
            r.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                     sweep=f"config-3 step, {n_tiles} ray tiles", **grid)
        log(f"[smoke bwd timing] config-3 step, {n_tiles} ray tiles x "
            f"{beams.shape[0]} chunks, {n_live} live blocks, {in_range} "
            f"pairs in range: {name} {ms:.3f} ms, "
            f"{n_live * BG.TILE * BG.CHUNK / ms / 1e6:.1f} Gpairs/s, bound "
            f"{bound_ms:.3f} ms ({bound_by}); launched {grid['n_splits']} "
            f"splits x {n_tiles} ray tiles = {grid['blocks']} d_rays blocks, "
            f"{grid['beam_blocks']} d_beams blocks")
    for n_tiles, parts in backward_kernel_ms(profiled).items():
        r["sweeps"][f"config3 {n_tiles} tiles timing"]["kernels_ms"] = parts
        log(f"[smoke bwd kernels] config-3 step, {n_tiles} ray tiles, device "
            f"ms per kernel (torch.profiler, mean of {PROFILE_REPS}): "
            + json.dumps({k: round(v, 3) for k, v in parts.items()}))
    if "plain_ms" not in r:
        r["plain_ms"] = r["sweeps"][f"{cases[0][0]} extras=False"]["plain_ms"]
    return r


def phase_smoke_trainer(dev):
    """(f) optimize_medium with examples/inverse_smoke.py's settings: three
    views at 64x64, 20k photons, fitting the 32^3 density from a constant
    start with the TV prior; targets averaged over INV_TARGET_ITERS
    iterations per view (the example takes 16)."""
    true = smoke_density()
    cams = [smoke_camera(dev, INV_WH, look) for look in SMOKE_LOOKS]
    cfg = smoke_cfg(INV_PHOTONS, radius=0.18)
    scene_true = smoke_scene(dev, true, g=0.3)
    targets = []
    with torch.no_grad():
        for vi, cam in enumerate(cams):
            run = MESH.sharded_photonbeam_iteration(
                scene_true, cam, INV_WH, INV_WH, cfg, None,
                light_power_distribution(scene_true))
            acc = sum(run(1000 + vi * 100 + i, 0.18)
                      for i in range(INV_TARGET_ITERS))
            targets.append((acc / INV_TARGET_ITERS).reshape(INV_WH, INV_WH, 3))
    start = np.full_like(true, float(true.mean()))
    scene0 = smoke_scene(dev, start, g=0.3)
    marks = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params, losses = INV.optimize_medium(
        scene0, cams, INV_WH, INV_WH, targets, cfg,
        INV.InverseConfig(steps=3, learning_rate=3e-2, n_devices=1,
                          optimize=("density",), tv_weight=2e-3,
                          view_block=25),
        callback=lambda it, loss, p: marks.append(time.perf_counter()))
    counts = launches(KERNELS + HET_KERNELS)
    per_step = np.diff([t0] + marks).tolist()
    d = params["density"].cpu().numpy()
    moved = float(np.abs(d - start).max())
    err = [float(np.abs(x - true).mean() / true.mean()) for x in (start, d)]
    log(f"[smoke trainer] optimize_medium, 3 views {INV_WH}x{INV_WH}, "
        f"{INV_PHOTONS} photons, radius 0.18, g 0.3, density only, tv_weight "
        f"2e-3, Adam lr 3e-2, targets of {INV_TARGET_ITERS} iterations: "
        f"s/step {per_step} (steps 2-3 mean {np.mean(per_step[1:]):.4f}); "
        f"losses {losses}; density moved up to {moved:.4f}, mean |density "
        f"err| {err[0]:.4f} -> {err[1]:.4f} of the mean; launches {counts}")
    if not all(np.isfinite(losses)) or not moved > 0 or (d < 0).any():
        raise AssertionError(f"smoke trainer: losses {losses}, moved {moved}")
    need = ("gather_forward_het", "gather_backward_fused_het")
    if any(counts[k] <= 0 for k in need):
        raise AssertionError(f"smoke trainer: kernels never launched: "
                             f"{need} ({counts})")
    return dict(per_step_s=per_step, losses=losses, density_moved=moved,
                density_rel_err=err, launches=counts,
                target_iters=INV_TARGET_ITERS)


def phase_smoke_consistency(dev):
    """(g) CUDA against the CPU on a small config-3 scene: the image and
    the density and sigma_s gradients."""
    size, photons = 32, 3000
    img_gpu, _, _ = render_smoke(dev, size, photons, 1)
    img_cpu, _, _ = render_smoke(torch.device("cpu"), size, photons, 1)
    check_image(img_gpu, size, "CUDA config-3 render")
    check_image(img_cpu, size, "CPU config-3 render")
    ch_gpu, ch_cpu = img_gpu.mean((0, 1)), img_cpu.mean((0, 1))
    rel_img = float(((ch_gpu - ch_cpu).abs() / ch_cpu).max())
    out = [fwd_bwd_smoke(smoke_scene(d), smoke_camera(d, size), size,
                         smoke_cfg(photons), 1)
           for d in (dev, torch.device("cpu"))]
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    check_grads(g_cpu, "CPU hetero step")
    rel = {k: float((g_gpu[k].cpu() - g_cpu[k]).abs().max()
                    / g_cpu[k].abs().max()) for k in g_cpu}
    log(f"[smoke consistency] config 3 at {size}x{size}, {photons} photons: "
        f"channel-mean max rel diff {rel_img:.3e} (limit "
        f"{CONSISTENCY_RTOL}); value CUDA {l_gpu:.7e} CPU {l_cpu:.7e}; "
        f"grads max |diff| / max |cpu| {rel} (limit {GRAD_CONSISTENCY_RTOL})")
    if not (rel_img <= CONSISTENCY_RTOL
            and abs(l_gpu / l_cpu - 1) <= CONSISTENCY_RTOL
            and max(rel.values()) <= GRAD_CONSISTENCY_RTOL):
        raise AssertionError("CUDA and CPU disagree on the config-3 scene")
    return dict(channel_rel_diff=rel_img, value_cuda=l_gpu, value_cpu=l_cpu,
                grad_rel_diff=rel)


# ---------------------------------------------------------------------------
# The default gather route (phases 20-25): gather_beams_bruteforce
# ---------------------------------------------------------------------------

# examples/cornell_fog.pbrt, the CLI's config 2 (256x256, 16 iterations of
# 65,536 photons, radius 0.15): phase 20 reads it with the port's parser
CORNELL_PBRT = os.path.join(ROOT, "examples", "cornell_fog.pbrt")
SMOKE_PBRT = os.path.join(ROOT, "examples", "smoke_hetero.pbrt")
# The two routes sum the same pairs in other orders (Morton-sorted chunks
# and an AABB cull on the packed route, validity-sorted chunks and no cull
# here) from the same photon and camera paths: the images differ by float
# rounding only.  Channel means within 1e-4 relative; 99% of the pixels
# within rtol 1e-3 (atol 1e-6 for the darkest).
ROUTE_RTOL, ROUTE_PIXEL_RTOL, ROUTE_PIXEL_SHARE = 1e-4, 1e-3, 0.99
# chunks of phase 24's R/4 sweep held against the plain version: those
# around the end of the flagged chunks (twopass_chunk_flags' extent), so the
# slice holds both flagged chunks and the dead tail the kernels skip
TWOPASS_PLAIN_CHUNKS = 64


def parse_cornell(dev, size=None):
    """examples/cornell_fog.pbrt through the port's parser (the camera on
    ``dev``); with ``size``, its Film resolution set to size x size."""
    text = open(CORNELL_PBRT).read()
    if size is not None:
        text = re.sub(r'"integer ([xy])resolution" \[ \d+ \]',
                      lambda m: f'"integer {m.group(1)}resolution" [ {size} ]',
                      text)
    return PARSER.parse_string(text, include_dir=os.path.dirname(CORNELL_PBRT),
                               device=dev)


def cli_cfg(ps, **over):
    """The PhotonBeamConfig the CLI builds from a parsed scene's Integrator
    line (cli.photonbeam_config), with ``over`` replaced."""
    return dataclasses.replace(CLI.photonbeam_config(ps), **over)


def routes_agree(img, img_ref, what):
    """The image of one route against the other's (ROUTE_* tolerances)."""
    ch, ch_ref = img.mean((0, 1)), img_ref.mean((0, 1))
    rel = float(((ch - ch_ref).abs() / ch_ref).max())
    share = float(torch.isclose(img, img_ref, rtol=ROUTE_PIXEL_RTOL,
                                atol=1e-6).all(-1).float().mean())
    diff = float((img - img_ref).abs().max())
    log(f"[routes] {what}: channel-mean max rel diff {rel:.3e} (limit "
        f"{ROUTE_RTOL}); pixels within rtol {ROUTE_PIXEL_RTOL}: {share:.5f} "
        f"(limit {ROUTE_PIXEL_SHARE}); max |diff| {diff:.3e}")
    if not (rel <= ROUTE_RTOL and share >= ROUTE_PIXEL_SHARE):
        raise AssertionError(f"{what}: the two gather routes disagree")
    return dict(channel_rel_diff=rel, pixel_share=share, max_abs_diff=diff)


def fwd_route_check(rays, beams, scal, label):
    """The forward kernel without a block mask, as the non-packed route
    launches it, against its plain version (rtol 2e-4 / atol 1e-8), timed
    with CUDA events beside its bound; every 4th ray tile when the sweep
    has more live blocks than PLAIN_MAX_LIVE."""
    live = int(G._live_chunks(beams.shape[0], BG.CHUNK, scal[0, 3],
                              beams.device).sum())
    which = "all tiles"
    if live * rays.shape[0] > PLAIN_MAX_LIVE:
        rays, which = rays[::4].contiguous(), "every 4th ray tile"
    ones = torch.ones((beams.shape[0], rays.shape[0]), device=rays.device)
    in_range, n_blocks = pairs_in_range(rays, beams, scal, ones)
    kern = lambda: G.gather_forward(rays, beams, scal)  # noqa: E731
    res = kern()
    torch.cuda.synchronize()
    plain_ms, ref = cuda_ms(lambda: G.gather_forward_ref(rays, beams, scal),
                            1, warm=False)
    abs_err = float((res - ref).abs().max())
    rel_err = float(((res - ref).abs() / (ref.abs() + ATOL)).max())
    ok = bool(torch.isfinite(res).all()) and bool(
        torch.allclose(res, ref, rtol=RTOL, atol=ATOL))
    ms, _ = cuda_ms(kern, 3)
    bound_ms, bound_by = bound(
        n_blocks * BG.TILE * BG.CHUNK * GEOM_OPS + in_range * FWD_IN_OPS,
        nbytes(rays, beams, scal) + rays.shape[0] * G.OUT_ROWS * BG.TILE * 4)
    log(f"[route parity] {label} ({which}: {rays.shape[0]} ray tiles x "
        f"{beams.shape[0]} chunks, {n_blocks} live blocks, {in_range} pairs "
        f"in range, no mask): gather_forward max rel err {rel_err:.3e} max "
        f"abs err {abs_err:.3e} allclose(rtol={RTOL}, atol={ATOL}) {ok}; "
        f"kernel {ms:.3f} ms ({n_blocks * BG.TILE * BG.CHUNK / ms / 1e6:.1f} "
        f"Gpairs/s), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by})")
    if not ok:
        raise AssertionError(f"gather_forward disagrees with its plain "
                             f"version on the {label} sweep")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=abs_err,
                max_rel_err=rel_err, live_blocks=n_blocks,
                pairs_in_range=in_range, bound_ms=bound_ms,
                bound_by=bound_by, tiles=which)


def phase_cli_config2(dev):
    """20. The CLI's config 2 on the default route, all 16 iterations:
    examples/cornell_fog.pbrt read by the port's parser, the config
    cli.photonbeam_config builds from it (imagewritefrequency 1 only times
    each iteration).  Returns the image too (phase 29 holds the CLI's
    against it)."""
    ps = PARSER.parse_file(CORNELL_PBRT, device=dev)
    scene, cam, size = ps.build(device=dev), ps.camera, ps.width
    cfg = cli_cfg(ps, imagewritefrequency=1)
    iters = cfg.iterations
    reset_launches()
    img, stats, per_iter = timed_render(scene, cam, size, cfg)
    counts, routes = launches(FWD_KERNELS), route_calls()
    mean = check_image(img, size, "CLI config-2 render")
    warm = float(np.mean(per_iter[1:]))
    log(f"[cli config 2] examples/cornell_fog.pbrt: {size}x{size}, "
        f"{cfg.photonsperiteration} photons/iter, {iters} iters, radius "
        f"{cfg.initialbeamradius}, maxdepth {cfg.maxdepth}, alpha "
        f"{cfg.alpha}, gather={cfg.gather}, grad_geometry="
        f"{cfg.grad_geometry}, gather_chunk={cfg.gather_chunk}: s/iter "
        f"{per_iter} (warm, iterations 2-{iters}: {warm:.4f}); valid "
        f"beams/iter {stats['n_beams'] / iters:.0f}; image mean {mean:.6f}, "
        f"finite; launches {counts}; route calls {routes}")
    if (counts["gather_forward"] <= 0 or routes["gather_beams_packed"] != 0
            or routes["gather_beams_bruteforce"] <= 0):
        raise AssertionError(f"the default config must take the non-packed "
                             f"route through the forward kernel: {counts}, "
                             f"{routes}")
    # one more iteration, phase by phase
    phases, sweeps = [], []
    saved = [(PB, n, _host_timed(PB, n, phases))
             for n in ("trace_photon_beams", "compact_beams")]
    saved += [(BG, "_pack_kernel_inputs",
               _host_timed(BG, "_pack_kernel_inputs", phases)),
              (BG, "gather_forward", _event_timed(BG, "gather_forward",
                                                  sweeps))]
    try:
        _, st1, it1 = timed_render(scene, cam, size, dataclasses.replace(
            cfg, iterations=iters + 1, startiteration=iters,
            enditeration=iters + 1))
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)
    torch.cuda.synchronize()
    by = {}
    for n, t in phases:
        by.setdefault(n, []).append(t)
    kernel = [(a[0].shape[0], a[1].shape[0], e0.elapsed_time(e1))
              for _, e0, e1, a in sweeps]
    breakdown = dict(
        iteration_s=it1[0], n_beams=st1["n_beams"],
        trace_s=sum(by["trace_photon_beams"]), compact_s=sum(by["compact_beams"]),
        pack_s_per_call=by["_pack_kernel_inputs"],
        kernel_ms_per_sweep=[dict(ray_tiles=t, chunks=c, ms=ms)
                             for t, c, ms in kernel])
    breakdown["rest_s"] = (it1[0] - breakdown["trace_s"] - breakdown["compact_s"]
                           - sum(by["_pack_kernel_inputs"])
                           - sum(ms for _, _, ms in kernel) / 1e3)
    log(f"[cli config 2 breakdown] iteration {iters + 1}: "
        f"{it1[0]:.4f} s, valid beams {st1['n_beams']}; trace "
        f"{breakdown['trace_s']:.4f} s, compaction {breakdown['compact_s']:.4f}"
        f" s, packing per call "
        f"{[round(t, 4) for t in by['_pack_kernel_inputs']]} s, kernel per "
        f"sweep " + ", ".join(f"{t} tiles x {c} chunks {ms:.3f} ms"
                              for t, c, ms in kernel)
        + f"; the rest of the camera walk {breakdown['rest_s']:.4f} s")
    # the largest sweep (the scene's back and side walls face away from
    # the fog, so only rays leaving the floor and the ceiling continue in
    # it, at most a quarter of the camera rays: the R/4 budget)
    rays, beams, scal = max((a for _, _, _, a in sweeps),
                            key=lambda a: a[0].shape[0])[:3]
    del sweeps
    # the same render on the packed route
    img_packed, _, per_packed = timed_render(
        scene, cam, size, dataclasses.replace(cfg, gather="pallas",
                                              grad_geometry=False))
    agree = routes_agree(img, img_packed, "CLI config 2, default route vs "
                         "packed route")
    checked = fwd_route_check(rays, beams, scal, f"CLI config-2 largest "
                              f"sweep, {rays.shape[0]} ray tiles")
    return dict(per_iter_s=per_iter, warm_s_per_iter=warm, image_mean=mean,
                n_beams_per_iter=stats["n_beams"] / iters,
                launches=counts, route_calls=routes, breakdown=breakdown,
                packed_per_iter_s=per_packed, routes=agree), checked, img


def phase_cli_config3(dev, img_packed):
    """21. The CLI's config 3 on the default route against phase 13's
    packed-route image."""
    cfg = PB.PhotonBeamConfig(iterations=SMOKE_ITERS, maxdepth=MAXDEPTH,
                              photonsperiteration=SMOKE_PHOTONS,
                              initialbeamradius=0.15, imagewritefrequency=1)
    reset_launches()
    img, stats, per_iter = timed_render(smoke_scene(dev),
                                        smoke_camera(dev, SMOKE_SIZE),
                                        SMOKE_SIZE, cfg)
    counts = launches(FWD_KERNELS + HET_FWD_KERNELS)
    routes = route_calls()
    mean = check_image(img, SMOKE_SIZE, "CLI config-3 render")
    log(f"[cli config 3] {SMOKE_SIZE}x{SMOKE_SIZE}, {SMOKE_PHOTONS} photons, "
        f"{SMOKE_ITERS} iters, radius 0.15, default config: s/iter {per_iter} "
        f"(warm {np.mean(per_iter[1:]):.4f}); valid beams/iter "
        f"{stats['n_beams'] / SMOKE_ITERS:.0f}; image mean {mean:.6f}; "
        f"launches {counts}; route calls {routes}")
    if counts["gather_forward_het"] <= 0 or routes["gather_beams_packed"]:
        raise AssertionError(f"config 3 on the default route must launch the "
                             f"hetero forward kernel: {counts}, {routes}")
    agree = routes_agree(img, img_packed, "CLI config 3, default route vs "
                         "phase 13's packed route")
    return dict(per_iter_s=per_iter, image_mean=mean, launches=counts,
                route_calls=routes, routes=agree,
                n_beams_per_iter=stats["n_beams"] / SMOKE_ITERS)


def _detached_gather_args(args, kw):
    beams, media, *segs = args
    det = lambda x: x.detach() if torch.is_tensor(x) else x  # noqa: E731
    return ((beams._replace(**{k: det(getattr(beams, k))
                               for k in beams._fields}),
             media._replace(**{k: det(getattr(media, k))
                               for k in media._fields}),
             *(det(x) for x in segs)), dict(kw))


def phase_attached_step(dev):
    """22. bench.py's fog box at the default config: the attached photon
    walk and the recompute backward."""
    wh, photons = BENCH_WH, BENCH_PHOTONS
    scene, cam = fog_box(dev, wh)
    cfg = PB.PhotonBeamConfig(maxdepth=MAXDEPTH, photonsperiteration=photons,
                              initialbeamradius=0.2)
    rec = []
    orig = PB.gather_beams_bruteforce

    def first_gather(*a, **k):
        if not rec:
            rec.append(_detached_gather_args(a, k))
        return orig(*a, **k)
    PB.gather_beams_bruteforce = first_gather
    try:
        t_warm, _, _ = timed_step(scene, cam, wh, cfg, 0)
    finally:
        PB.gather_beams_bruteforce = orig
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    steps = [timed_step(scene, cam, wh, cfg, it) for it in (1, 2)]
    counts = launches(KERNELS + TWOPASS_KERNELS)
    routes = route_calls()
    peak = torch.cuda.max_memory_allocated(dev)
    for _, loss, grads in steps:
        if not np.isfinite(loss):
            raise AssertionError(f"attached step: loss {loss}")
        check_grads(grads, "attached step")
    per_step = [t for t, _, _ in steps]
    log(f"[attached step] fog box {wh}x{wh}, {photons} photons, maxdepth "
        f"{MAXDEPTH}, radius 0.2, default config (grad_geometry=True, "
        f"grad_extras=True): warm step {t_warm:.4f} s, s/step {per_step} "
        f"(mean {np.mean(per_step):.4f}), peak memory {peak / 2**30:.3f} GiB; "
        f"value {steps[-1][1]:.6e}; grads {fmt_values(steps[-1][2])}; "
        f"launches {counts}; route calls {routes}")
    if counts["gather_forward"] <= 0 or routes["gather_beams_packed"]:
        raise AssertionError(f"attached step: {counts}, {routes}")
    # the card against the CPU at 32x32 x 4,000
    small = []
    for d in (dev, torch.device("cpu")):
        sc, cm = fog_box(d, 32)
        small.append(fwd_bwd(sc, cm, 32, PB.PhotonBeamConfig(
            maxdepth=MAXDEPTH, photonsperiteration=4000,
            initialbeamradius=0.2), 1))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = small
    check_grads(g_cpu, "CPU attached step")
    rel = {k: float((g_gpu[k].cpu() - g_cpu[k]).abs().max()
                    / g_cpu[k].abs().max()) for k in g_cpu}
    log(f"[attached step] 32x32, 4000 photons: value CUDA {l_gpu:.7e} CPU "
        f"{l_cpu:.7e}; grads max |diff| / max |cpu| {rel} (limit "
        f"{GRAD_CONSISTENCY_RTOL})")
    if not (abs(l_gpu / l_cpu - 1) <= CONSISTENCY_RTOL
            and max(rel.values()) <= GRAD_CONSISTENCY_RTOL):
        raise AssertionError("attached step: CUDA and CPU disagree")
    if not rec:
        raise AssertionError("attached step: no gather was called")
    return dict(warm_s=t_warm, per_step_s=per_step, peak_memory_bytes=peak,
                values=[s[1] for s in steps], grads=fmt_values(steps[-1][2]),
                launches=counts, route_calls=routes,
                consistency=dict(value_cuda=l_gpu, value_cpu=l_cpu,
                                 grad_rel_diff=rel)), rec[0]


ANALYTIC_LEAVES = ("power_start", "power_end", "radius", "tr", "sigma_s",
                   "g", "cam_radius")


def _analytic_run(gather_args, kw, enabled, mode, W):
    """One fwd+bwd of the captured gather with the geometry detached:
    the cotangents in ANALYTIC_LEAVES."""
    beams, media, a0, a1, d, med, tr, cam_radius = gather_args
    leaves = dict(power_start=beams.power_start, power_end=beams.power_end,
                  radius=beams.radius, tr=tr, sigma_s=media.sigma_s,
                  g=media.g, cam_radius=torch.as_tensor(
                      cam_radius, dtype=torch.float32, device=a0.device))
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    BG.PALLAS_BWD_ENABLED, BG.PALLAS_BWD_MODE = enabled, mode
    out = BG.gather_beams_bruteforce(
        beams._replace(power_start=leaves["power_start"],
                       power_end=leaves["power_end"],
                       radius=leaves["radius"]),
        media._replace(sigma_s=leaves["sigma_s"], g=leaves["g"]), a0, a1, d,
        med, leaves["tr"], leaves["cam_radius"],
        **{**kw, "backend": "pallas", "grad_geometry": False,
           "grad_extras": True})
    grads = torch.autograd.grad((out * W).sum(), list(leaves.values()))
    return dict(zip(leaves, grads))


def phase_analytic_bwd(captured):
    """23. The analytic backward kernels on the non-packed layout against
    the recompute backward; kernel 6 against its plain version."""
    gather_args, kw = captured
    R = gather_args[2].shape[0]
    W = torch.from_numpy(np.random.RandomState(23).uniform(
        0, 1, (R, 3)).astype(np.float32)).to(gather_args[2].device)
    packed = []
    orig_tp = BG.gather_backward_twopass

    def record(*a):
        packed.append(a)
        return orig_tp(*a)
    saved = (BG.PALLAS_BWD_ENABLED, BG.PALLAS_BWD_MODE)
    out = {}
    try:
        ref = _analytic_run(gather_args, kw, False, "fused", W)
        BG.gather_backward_twopass = record
        for mode in ("fused", "twopass"):
            reset_launches()
            got = _analytic_run(gather_args, kw, True, mode, W)
            counts = launches(KERNELS + TWOPASS_KERNELS)
            errs = {}
            for k, r in ref.items():
                r_max = float(r.abs().max())
                err = float((got[k] - r).abs().max())
                if not (bool(torch.isfinite(got[k]).all())
                        and err <= BWD_RTOL * (r_max + 1e-9)):
                    raise AssertionError(f"{mode} backward: d {k} max |diff| "
                                         f"{err}, max |ref| {r_max}")
                errs[k] = err / (r_max + 1e-9)
            log(f"[analytic bwd] {mode}: {R} rays, chunk {kw.get('chunk')}: "
                f"per cotangent max |diff| / max|recompute| "
                + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
                + f"; launches {counts}")
            need = ("gather_backward_fused" if mode == "fused"
                    else "gather_backward_twopass")
            if counts[need] <= 0:
                raise AssertionError(f"{mode}: {need} never launched")
            out[mode] = dict(err_over_max_ref=errs, launches=counts)
    finally:
        BG.gather_backward_twopass = orig_tp
        BG.PALLAS_BWD_ENABLED, BG.PALLAS_BWD_MODE = saved
    rays, beams, scal, ct = packed[0]
    k1 = GB.gather_backward_twopass(rays, beams, scal, ct)
    k2 = GB.gather_backward_twopass(rays, beams, scal, ct)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(k1, k2))
    plain_ms, ref6 = cuda_ms(lambda: GB.gather_backward_twopass_ref(
        rays, beams, scal, ct), 1, warm=False)
    errs6 = _bwd_close(k1, ref6, "gather_backward_twopass (phase 22's gather)")
    ms, _ = cuda_ms(lambda: GB.gather_backward_twopass(rays, beams, scal, ct),
                    3)
    grid = launched_grid(GB.gather_backward_twopass)
    ones = torch.ones((beams.shape[0], rays.shape[0]), device=rays.device)
    fused_ms, _ = cuda_ms(lambda: GB.gather_backward_fused(
        rays, beams, scal, ct, ones, True), 3)
    bnd = twopass_bound(rays, beams, scal, ct)
    log(f"[twopass parity] phase 22's first in-medium gather ({rays.shape[0]} "
        f"ray tiles x {beams.shape[0]} chunks, {bnd['flagged_chunks']} with a "
        f"live power): per cotangent max |diff| / "
        f"max|ref| " + json.dumps({k: float(f"{v:.3e}") for k, (_, v) in
                                   errs6.items()})
        + f"; two runs bit-identical {identical}; kernel {ms:.3f} ms "
        f"({grid['n_splits']} splits per ray tile), plain {plain_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}; whole grid "
        f"{bnd['grid_bound_ms']:.3f} ms); gather_backward_fused (all-ones "
        f"mask, extras on) {fused_ms:.3f} ms")
    if not identical:
        raise AssertionError("gather_backward_twopass is not deterministic")
    _twopass_zeros(k1, beams, "phase 22's gather")
    name, _, rep, src = TWOPASS_KERNELS[0]
    row = dict(name=name, route="cuda", source=src, replaces=rep,
               max_abs_err=max(e for e, _ in errs6.values()),
               err_over_max_ref={k: v for k, (_, v) in errs6.items()},
               ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
               bound_by=bnd["bound_by"], library_ms=None,
               sweep="phase 22's first in-medium gather",
               **grid,
               sweeps={"phase 22 gather": dict(ms=ms, plain_ms=plain_ms,
                                               fused_ms=fused_ms, **bnd)})
    return out, row, (rays, beams, scal, ct)


def _twopass_zeros(d, beams, what):
    """Kernel 6's d_beams in the chunks without a live start power: exact
    zeros (the kernels skip those chunks)."""
    flags, _ = GB.twopass_chunk_flags(beams)
    if bool((~flags).any()) and float(d[1][~flags].abs().max()) != 0.0:
        raise AssertionError(f"gather_backward_twopass ({what}): an unflagged "
                             f"chunk's d_beams are not zero")


def twopass_bound(rays, beams, scal, ct):
    """Kernel 6's bound: the least work for its function.  An unflagged
    chunk (no beam with a live start power, twopass_chunk_flags) adds exact
    zeros, which a per-beam test shows, so only the pairs of the flagged
    chunks pay the geometry, and those in range the backward terms with the
    extras.  ``grid_bound_ms``: the earlier figure, the geometry on every
    pair of the grid."""
    n_chunks, n_tiles = beams.shape[0], rays.shape[0]
    flags, extent = GB.twopass_chunk_flags(beams)
    flagged = flags[:, None].expand(n_chunks, n_tiles).to(torch.float32)
    every = scal.clone()
    every[0, 3] = n_chunks * BG.CHUNK  # the whole grid, not n_valid's chunks
    in_range, _ = pairs_in_range(rays, beams, every, flagged)
    n_flagged = int(flags.sum())
    pairs = n_tiles * n_flagged * BG.TILE * BG.CHUNK
    all_pairs = n_tiles * n_chunks * BG.TILE * BG.CHUNK
    in_ops = in_range * (BWD_IN_OPS + BWD_EXTRAS_OPS)
    n_bytes = nbytes(rays, beams, scal, ct, rays[:, :GB.NDR], beams)
    ms, by = bound(pairs * GEOM_OPS + in_ops, n_bytes)
    grid_ms, _ = bound(all_pairs * GEOM_OPS + in_ops, n_bytes)
    return dict(bound_ms=ms, bound_by=by, grid_bound_ms=grid_ms, pairs=pairs,
                grid_pairs=all_pairs, pairs_in_range=in_range,
                flagged_chunks=n_flagged, extent=int(extent))


def phase_twopass_timing(spec_sweeps, row, gather22):
    """24. Kernel 6 on the spec step's shapes, beside its bound and the
    fused kernels on the same inputs (all-ones mask, extras on); its plain
    version on a slice of the R/4 sweep's chunks around the end of the
    flagged ones; both kernels' d_rays and d_beams sweeps apart, on these
    sweeps and phase 22's gather."""
    profiled = {"phase 22 gather": ("gather_backward_twopass", gather22)}
    rays22, beams22, scal22, ct22 = gather22
    profiled["phase 22 gather, fused"] = ("gather_backward_fused", (
        rays22, beams22, scal22, ct22,
        torch.ones((beams22.shape[0], rays22.shape[0]),
                   device=rays22.device), True))
    for label in ("r4", "full"):
        beams, rays, scal, mask, ct = spec_sweeps[label][:5]
        ct_p = BG.pack_ct(ct, rays.shape[0])
        if label == "r4":
            _, extent = GB.twopass_chunk_flags(beams)
            lo = max(0, min(int(extent), beams.shape[0])
                     - TWOPASS_PLAIN_CHUNKS // 2)
            sl = beams[lo:lo + TWOPASS_PLAIN_CHUNKS].contiguous()
            got = GB.gather_backward_twopass(rays, sl, scal, ct_p)
            torch.cuda.synchronize()
            plain_ms, ref = cuda_ms(lambda: GB.gather_backward_twopass_ref(
                rays, sl, scal, ct_p), 1, warm=False)
            errs = _bwd_close(got, ref, f"gather_backward_twopass (spec R/4, "
                              f"chunks {lo}-{lo + sl.shape[0] - 1})")
            _twopass_zeros(got, sl, "spec R/4 slice")
            row["max_abs_err"] = max([row["max_abs_err"]]
                                     + [e for e, _ in errs.values()])
            for k, (_, v) in errs.items():
                row["err_over_max_ref"][k] = max(row["err_over_max_ref"][k], v)
            row["sweeps"]["spec r4 slice"] = dict(
                chunks=[lo, lo + sl.shape[0]], plain_ms=plain_ms,
                err_over_max_ref={k: v for k, (_, v) in errs.items()})
            log(f"[twopass parity] spec R/4 sweep, chunks {lo}-"
                f"{lo + sl.shape[0] - 1} (the flagged ones end at "
                f"{int(extent)}): per cotangent max |diff| / "
                f"max|ref| " + json.dumps({k: float(f"{v:.3e}") for k, (_, v)
                                           in errs.items()})
                + f"; plain {plain_ms:.3f} ms")
            del ref, got
        ms, out = cuda_ms(lambda: GB.gather_backward_twopass(
            rays, beams, scal, ct_p), 3)
        _twopass_zeros(out, beams, f"spec {label}")
        del out
        grid = launched_grid(GB.gather_backward_twopass)
        ones = torch.ones_like(mask)
        fused_ms, _ = cuda_ms(lambda: GB.gather_backward_fused(
            rays, beams, scal, ct_p, ones, True), 3)
        bnd = twopass_bound(rays, beams, scal, ct_p)
        row["sweeps"][f"spec {label}"] = dict(ms=ms, fused_ms=fused_ms,
                                              **grid, **bnd)
        log(f"[twopass timing] spec {label} sweep ({rays.shape[0]} ray tiles x "
            f"{beams.shape[0]} chunks, {bnd['flagged_chunks']} with a live "
            f"power, extent {bnd['extent']}; {bnd['pairs']} pairs there, "
            f"{bnd['pairs_in_range']} in range): gather_backward_twopass "
            f"{ms:.3f} ms ({bnd['pairs'] / ms / 1e6:.1f} Gpairs/s; "
            f"{grid['n_splits']} splits x {rays.shape[0]} ray tiles = "
            f"{grid['blocks']} d_rays blocks), bound {bnd['bound_ms']:.3f} ms "
            f"({bnd['bound_by']}; whole grid {bnd['grid_bound_ms']:.3f} ms); "
            f"gather_backward_fused (all-ones mask, extras on, dead-chunk "
            f"skip) {fused_ms:.3f} ms, twopass / fused "
            f"{ms / fused_ms:.3f}")
        profiled[f"spec {label}"] = ("gather_backward_twopass",
                                     (rays, beams, scal, ct_p))
        profiled[f"spec {label}, fused"] = ("gather_backward_fused", (
            rays, beams, scal, ct_p, ones, True))
    for label, parts in backward_kernel_ms(profiled).items():
        key = label.replace(", fused", "")
        sweep = row["sweeps"][key]
        sweep["fused_kernels_ms" if label.endswith("fused")
              else "kernels_ms"] = parts
        log(f"[twopass kernels] {label}: device ms per kernel "
            f"(torch.profiler, mean of {PROFILE_REPS}): "
            + json.dumps({k: round(v, 3) for k, v in parts.items()}))
    return row


def phase_breadth(dev):
    """25. gather="brute" (forward and a gradient) and rendermedia=False on
    the card against the CPU at 64x64 x 20k photons."""
    size, photons = 64, 20_000
    one_iter = dict(iterations=1, enditeration=1, photonsperiteration=photons,
                    imagewritefrequency=1)
    out = {}
    for label, over in (("brute", dict(gather="brute")),
                        ("rendermedia=False", dict(rendermedia=False))):
        imgs = []
        for d in (dev, torch.device("cpu")):
            ps = parse_cornell(d, size)
            reset_launches()
            img, _, t = timed_render(ps.build(device=d), ps.camera, size,
                                     cli_cfg(ps, **one_iter, **over))
            imgs.append((check_image(img, size, f"{label} render on {d}"),
                         img, t[0], launches(FWD_KERNELS)))
        (m_gpu, i_gpu, t_gpu, c_gpu), (m_cpu, i_cpu, t_cpu, _) = imgs
        rel = float(((i_gpu.mean((0, 1)) - i_cpu.mean((0, 1))).abs()
                     / i_cpu.mean((0, 1))).max())
        log(f"[breadth] {label}, {size}x{size}, {photons} photons, 1 iter: "
            f"mean CUDA {m_gpu:.7f} CPU {m_cpu:.7f}, channel-mean max rel "
            f"diff {rel:.3e} (limit {CONSISTENCY_RTOL}); s CUDA {t_gpu:.2f} "
            f"CPU {t_cpu:.2f}; kernel launches on the card {c_gpu}")
        if not rel <= CONSISTENCY_RTOL or sum(c_gpu.values()):
            raise AssertionError(f"{label}: CUDA and CPU disagree, or a "
                                 f"gather kernel launched ({c_gpu})")
        out[label] = dict(mean_cuda=m_gpu, mean_cpu=m_cpu,
                          channel_rel_diff=rel)
    grads = []
    for d in (dev, torch.device("cpu")):
        ps = parse_cornell(d, size)
        scene = ps.build(device=d)
        grads.append(fwd_bwd(scene, ps.camera, size, cli_cfg(
            ps, **one_iter, gather="brute",
            tr_crossings=PB.default_tr_crossings(scene)), 1))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = grads
    check_grads(g_cpu, "CPU brute step")
    rel = {k: float((g_gpu[k].cpu() - g_cpu[k]).abs().max()
                    / g_cpu[k].abs().max()) for k in g_cpu}
    log(f"[breadth] gather=brute gradient, {size}x{size}, {photons} photons: "
        f"value CUDA {l_gpu:.7e} CPU {l_cpu:.7e}; grads CPU "
        f"{fmt_values(g_cpu)}; max |diff| / max |cpu| {rel} (limit "
        f"{GRAD_CONSISTENCY_RTOL})")
    if not (abs(l_gpu / l_cpu - 1) <= CONSISTENCY_RTOL
            and max(rel.values()) <= GRAD_CONSISTENCY_RTOL):
        raise AssertionError("gather=brute: CUDA and CPU gradients disagree")
    out["brute_grad"] = dict(value_cuda=l_gpu, value_cpu=l_cpu,
                             grad_rel_diff=rel)
    return out


# ---------------------------------------------------------------------------
# Several ranks (phases 26-27) and the index-order dot (phase 28)
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_nccl_world1(dev, card):
    """26. phase 9's spec step (fog box, 256x256, 1M photons, geometry
    detached) as make_inverse_train_step's loss mean(Ld^2) over the
    one-rank NCCL mesh, bit for bit the one-device mesh's; s/step and peak
    memory of both, the NCCL step counted."""
    wh, photons = SPEC_WH, SPEC_PHOTONS
    scene, cam = fog_box(dev, wh)
    cfg = PB.PhotonBeamConfig(maxdepth=MAXDEPTH, photonsperiteration=photons,
                              initialbeamradius=0.1, gather="auto",
                              grad_geometry=False, grad_extras=False)
    params = {k: getattr(scene.media, k) for k in DRYRUN.PARAMS}
    target = torch.zeros((wh * wh, 3), device=dev)

    def timed(step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, grads = step(params, target, 1, 0.1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev),
                loss, grads)

    one = MESH.make_inverse_train_step(scene, cam, wh, wh, cfg)
    t_one_warm = timed(one)[0]
    t_one, peak_one, loss_one, g_one = timed(one)
    mesh = MESH.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                       backend="nccl")
    try:
        if (mesh.size, mesh.rank, mesh.device, dist.get_backend()) != (
                1, 0, dev, "nccl"):
            raise AssertionError(f"NCCL world size 1: mesh {mesh}")
        step = MESH.make_inverse_train_step(scene, cam, wh, wh, cfg, mesh)
        t_warm = timed(step)[0]
        reset_launches()
        t_nccl, peak, loss, grads = timed(step)
        counts = launches()
    finally:
        dist.destroy_process_group()
    # grad_extras=False: g's gradient is 0, as in phase 9
    check_grads({k: grads[k] for k in ("sigma_a", "sigma_s")},
                "NCCL world-size-1 step")
    identical = torch.equal(loss, loss_one) and all(
        torch.equal(grads[k], g_one[k]) for k in grads)
    log(f"[nccl x1] {card}: spec step (fog box {wh}x{wh}, {photons} photons, "
        f"radius 0.1, gather=auto, geometry detached), loss mean(Ld^2): "
        f"one-device mesh warm {t_one_warm:.4f} s, {t_one:.4f} s/step, peak "
        f"{peak_one / 2**30:.3f} GiB; NCCL world size 1 warm {t_warm:.4f} s "
        f"(the communicator starts), {t_nccl:.4f} s/step, peak "
        f"{peak / 2**30:.3f} GiB; loss {float(loss):.9e}, grads "
        f"{fmt_values(grads)}; bit-identical {identical}; launches {counts}")
    if not identical:
        raise AssertionError("NCCL world size 1 differs from the one-device "
                             "mesh")
    missing = [k for k in ("gather_forward", "gather_backward_fused")
               if counts[k] <= 0]
    if missing:
        raise AssertionError(f"NCCL world size 1: kernels never launched: "
                             f"{missing} ({counts})")
    return dict(one_device_warm_s=t_one_warm, one_device_s=t_one,
                one_device_peak_bytes=peak_one, warm_s=t_warm, step_s=t_nccl,
                peak_memory_bytes=peak, loss=float(loss),
                grads=fmt_values(grads), bit_identical=identical,
                launches=counts)


def phase_ranks(card):
    """27. dryrun_multichip: two gloo ranks sharing the card at the graft
    size and at bench.py's 128x128 x 50k, and one NCCL rank at the graft
    size, each against the one-device step (the reference's invariant),
    with every rank's kernel launches in its sharded step."""
    out = {}
    for label, n, backend, size in (("gloo x2 graft", 2, "gloo", "graft"),
                                    ("gloo x2 bench", 2, "gloo", "bench"),
                                    ("nccl x1 graft", 1, "nccl", "graft")):
        t0 = time.perf_counter()
        res = DRYRUN.dryrun_multichip(n, device="cuda", backend=backend,
                                      size=size)
        res["command_s"] = time.perf_counter() - t0
        log(f"[ranks] {label}, {card}: loss {res['loss']:.9e} one-device "
            f"{res['loss_1']:.9e}, loss rel {res['loss_rel']:.3e} (limit "
            f"{DRYRUN.LOSS_RTOL}), grad max|diff|/max|one-device| "
            f"{res['grad_rel']} (sigma_a limit {DRYRUN.GRAD_RTOL}), "
            f"bit-identical {res['bit_identical']}; sharded step "
            f"{res['step_s']:.4f} s, one-device {res['step_1_s']:.4f} s "
            f"(first calls; correctness runs), {res['command_s']:.1f} s in "
            f"all; launches per rank {res['launches_per_rank']}")
        fwd = ("gather_forward", "gather_sparse")
        bwd = ("gather_backward_fused", "gather_backward_sparse")
        for rank, c in enumerate(res["launches_per_rank"]):
            # the graft size takes the default route: the forward kernel and
            # the plain recompute backward; bench the packed route
            need = (fwd, bwd) if size == "bench" else (fwd,)
            if not all(sum(c[k] for k in ks) > 0 for ks in need):
                raise AssertionError(f"{label}: rank {rank} launched {c}")
        if n == 1 and not res["bit_identical"]:
            raise AssertionError(f"{label}: one rank differs from the "
                                 "one-device mesh")
        out[label] = res
    return out


def phase_dot_order(dev):
    """28. core.math.dot and length_squared on the card over the camera
    walk's own vectors (every dot of the intersector and the BSDF in a
    64x64, 20,000-photon config-2 render): bit for bit (a0 b0 + a1 b1) +
    a2 b2 in numpy float32; how often the card's sum(-1) differs is
    logged."""
    rec = []
    orig = CMATH.dot

    def recording(a, b):
        rec.append((a.detach(), b.detach()))
        return orig(a, b)
    saved = [(m, m.dot) for m in (ISECT, MAT)]
    for m, _ in saved:
        m.dot = recording
    try:
        render(dev, 64, 20_000, 1)
    finally:
        for m, fn in saved:
            m.dot = fn
    n_lanes = n_sum_diff = 0
    for a, b in rec:
        a, b = torch.broadcast_tensors(a, b)
        an, bn = a.cpu().numpy(), b.cpu().numpy()
        with np.errstate(over="ignore", invalid="ignore"):  # 1e30 sentinels
            want = (an[..., 0] * bn[..., 0] + an[..., 1] * bn[..., 1]) \
                + an[..., 2] * bn[..., 2]
            want_sq = (an[..., 0] * an[..., 0] + an[..., 1] * an[..., 1]) \
                + an[..., 2] * an[..., 2]
        if not (np.array_equal(CMATH.dot(a, b).cpu().numpy(), want)
                and np.array_equal(CMATH.length_squared(a).cpu().numpy(),
                                   want_sq)):
            raise AssertionError(f"core.math.dot on the card is not the "
                                 f"index-order sum (shape {tuple(a.shape)})")
        n_lanes += want.size
        n_sum_diff += int(((a * b).sum(-1).cpu().numpy() != want).sum())
    log(f"[dot order] {len(rec)} dot calls, {n_lanes} lanes: core.math.dot "
        f"and length_squared bit for bit the index-order sum; the card's "
        f"sum(-1) differs at {n_sum_diff} lanes")
    if not rec:
        raise AssertionError("the render made no dot call")
    return dict(calls=len(rec), lanes=n_lanes, sum_minus1_differs=n_sum_diff)


# ---------------------------------------------------------------------------
# The CLI (phase 29): scene input, image output and checkpoint/resume
# ---------------------------------------------------------------------------


def cli_run(args, kernels, what):
    """bre_tpu_torch.cli.main(args) in this process, counted: the counters
    set to 0 just before and read just after.  (wall s, launches, route
    calls)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = CLI.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = launches(kernels), route_calls()
    if rc != 0:
        raise AssertionError(f"{what}: the CLI returned {rc}")
    return wall, counts, routes


def phase_cli(dev, img_cli2):
    """29. The CLI: (a) examples/cornell_fog.pbrt through cli.main, its PFM
    bit for bit phase 20's image; (b) examples/smoke_hetero.pbrt through
    cli.main, against the same parsed scene on the packed route; (c) the
    parsed config 2 split at iteration 8 by a checkpoint, the resumed image
    bit for bit phase 20's; (d) python -m bre_tpu_torch.cli in a child
    process."""
    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    ps2 = PARSER.parse_file(CORNELL_PBRT, device=dev)
    cfg2 = cli_cfg(ps2)
    iters = cfg2.iterations
    # (a) config 2
    pfm = os.path.join(out_dir, "cornell_fog.pfm")
    wall, counts, routes = cli_run([CORNELL_PBRT, "-o", pfm, "--quiet"],
                                   FWD_KERNELS, "CLI config 2")
    img = torch.from_numpy(IMG.read_pfm(pfm))
    n_diff = int((img != img_cli2).any(-1).sum())
    log(f"[cli] (a) python -m bre_tpu_torch.cli examples/cornell_fog.pbrt "
        f"(in process): wall {wall:.3f} s for {iters} iterations "
        f"({wall / iters:.4f} s/iter, parse, build and PFM write included); "
        f"launches {counts}; route calls {routes}; pixels differing from "
        f"phase 20's image: {n_diff}")
    if (counts["gather_forward"] <= 0 or routes["gather_beams_packed"]
            or n_diff):
        raise AssertionError(f"the CLI's config 2 must launch the forward "
                             f"kernel, never the packed route, and equal "
                             f"phase 20's image: {counts}, {routes}, {n_diff} "
                             f"pixels differ")
    out["config2"] = dict(wall_s=wall, s_per_iter=wall / iters,
                          launches=counts, route_calls=routes,
                          pixels_differing=n_diff)
    # (b) config 3
    t0 = time.perf_counter()
    ps = PARSER.parse_file(SMOKE_PBRT, device=dev)
    parse_s = time.perf_counter() - t0
    pfm = os.path.join(out_dir, "smoke_hetero.pfm")
    wall3, counts3, routes3 = cli_run([SMOKE_PBRT, "-o", pfm, "--quiet"],
                                      FWD_KERNELS + HET_FWD_KERNELS,
                                      "CLI config 3")
    cfg3 = CLI.photonbeam_config(ps)
    img3 = torch.from_numpy(IMG.read_pfm(pfm))
    check_image(img3, ps.width, "CLI config-3 render")
    log(f"[cli] (b) examples/smoke_hetero.pbrt ({os.path.getsize(SMOKE_PBRT)} "
        f"bytes): parse_file {parse_s:.4f} s on the host; the CLI (in "
        f"process) wall {wall3:.3f} s for {cfg3.iterations} iterations "
        f"({wall3 / cfg3.iterations:.4f} s/iter); launches {counts3}; route "
        f"calls {routes3}")
    if counts3["gather_forward_het"] <= 0 or routes3["gather_beams_packed"]:
        raise AssertionError(f"the CLI's config 3 must launch the hetero "
                             f"forward kernel and never the packed route: "
                             f"{counts3}, {routes3}")
    img_packed, _, per_packed = timed_render(
        ps.build(device=dev), ps.camera, ps.width, dataclasses.replace(
            cfg3, gather="pallas", grad_geometry=False, imagewritefrequency=1))
    agree = routes_agree(img3, img_packed, "CLI config 3 vs the same parsed "
                         "scene on the packed route")
    out["config3"] = dict(parse_file_s=parse_s, wall_s=wall3,
                          s_per_iter=wall3 / cfg3.iterations,
                          launches=counts3, route_calls=routes3,
                          packed_per_iter_s=per_packed, routes=agree)
    # (c) checkpoint and resume
    scene = ps2.build(device=dev)
    ck = os.path.join(out_dir, "cornell_fog_checkpoint.npz")
    if os.path.exists(ck):
        os.remove(ck)
    half = iters // 2
    _, _, first = timed_render(scene, ps2.camera, ps2.width,
                               dataclasses.replace(cfg2, enditeration=half,
                                                   imagewritefrequency=half),
                               checkpoint_path=ck)
    resumed, _, rest = timed_render(scene, ps2.camera, ps2.width,
                                    dataclasses.replace(cfg2,
                                                        imagewritefrequency=1),
                                    checkpoint_path=ck)
    n_diff = int((resumed != img_cli2).any(-1).sum())
    log(f"[cli] (c) checkpoint at iteration {half}: first run "
        f"{sum(first):.3f} s, resumed run {len(rest)} iterations "
        f"{sum(rest):.3f} s; pixels differing from phase 20's image: "
        f"{n_diff}")
    if len(rest) != iters - half or n_diff:
        raise AssertionError(f"the resumed render ran {len(rest)} iterations "
                             f"and differs from phase 20's at {n_diff} pixels")
    out["resume"] = dict(first_s=sum(first), resumed_iterations=len(rest),
                         resumed_s=sum(rest), pixels_differing=n_diff)
    # (d) the module entry point, in a child process
    png = os.path.join(out_dir, "fog_cube.png")
    if os.path.exists(png):
        os.remove(png)
    cmd = [sys.executable, "-m", "bre_tpu_torch.cli",
           os.path.join(ROOT, "examples", "fog_cube.pbrt"), "--quick", "-o",
           png]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall_d = time.perf_counter() - t0
    log(f"[cli] (d) {' '.join(cmd[1:])}: rc {proc.returncode}, "
        f"{wall_d:.2f} s; stdout: {proc.stdout.strip()!r}")
    if proc.returncode != 0:
        raise AssertionError(f"python -m bre_tpu_torch.cli failed:\n"
                             f"{proc.stderr}")
    png_img = IMG.read_png(png)
    if png_img.shape != (64, 64, 3) or not np.isfinite(png_img).all():
        raise AssertionError(f"fog_cube.png: shape {png_img.shape}, finite "
                             f"{bool(np.isfinite(png_img).all())}")
    out["module"] = dict(returncode=proc.returncode, wall_s=wall_d,
                         png_mean=float(png_img.mean()))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[cli] phase 29 took {out['phase_s']:.2f} s")
    return out


# ---------------------------------------------------------------------------
# The reference-matching path and the volpath oracle (phase 30)
# ---------------------------------------------------------------------------

# BASELINE config 1 (examples/fog_cube.pbrt: 64x64, 8 iterations x 10,000
# photons, maxdepth 5) and the C++ reference renderer's statistics for it
# (BASELINE.md, "Round-3: the north-star comparison")
FOG_CUBE_PBRT = os.path.join(ROOT, "examples", "fog_cube.pbrt")
REF_CONFIG1 = dict(photon_paths=80_000, n_medium_scatter=67_452,
                   n_beams=173_641, channel_means=(0.0352, 0.0311, 0.0271))
CONFIG1_RTOL = 0.02  # medium interactions, beams and each channel mean


def _cli_stats(text):
    """{name: int} of the ``  name: value`` lines cli.main prints."""
    out = {}
    for m in re.finditer(r"^  (\w+): (-?\d+)$", text, re.M):
        out[m.group(1)] = int(m.group(2))
    return out


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_compat_volpath(dev, card):
    """30. (a) BASELINE config 1 through cli.main --kernel compat at its
    full size, counted (no kernel may launch: the compat kernel is the
    plain chunk scan), its statistics and channel means against the C++
    reference's, and one iteration timed as trace and camera pass; (b) the
    two golden gates against the reference's images; (c) and (d) the
    volpath oracle against the photon-beam render on the fog cube and on
    the grid smoke (tests/test_photonbeam_vs_volpath.py's scenes, sizes and
    _check tolerances)."""
    import contextlib
    import io

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_reference_golden import fog_gate, smoke_gate
    from test_torch_volpath_oracle import ORACLES, _check
    from bre_tpu_torch.integrators.photon_trace import \
        trace_photon_beams_compat
    from bre_tpu_torch.integrators.volpath import render_volpath

    t_phase = time.perf_counter()
    out = {"card": card}
    # (a) config 1 through the CLI
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        pfm = os.path.join(tmp, "fog_cube_compat.pfm")
        reset_launches()
        with contextlib.redirect_stdout(buf):
            (rc, wall) = _timed(lambda: CLI.main(
                [FOG_CUBE_PBRT, "--kernel", "compat", "-o", pfm]))
        counts = launches(KERNELS + HET_KERNELS + TWOPASS_KERNELS)
        routes = route_calls()
        if rc != 0:
            raise AssertionError(f"cli --kernel compat returned {rc}: "
                                 f"{buf.getvalue()}")
        img = torch.from_numpy(IMG.read_pfm(pfm))
    stats = _cli_stats(buf.getvalue())
    check_image(img, 64, "config-1 compat render")
    means = img.mean((0, 1)).tolist()
    ps = PARSER.parse_file(FOG_CUBE_PBRT, device=dev)
    cfg = CLI.photonbeam_config(ps, kernel="compat")
    iters = cfg.iterations
    ref = REF_CONFIG1
    rel = dict(
        n_medium_scatter=stats["n_medium_scatter"] / ref["n_medium_scatter"]
        - 1.0,
        n_beams=stats["n_beams"] / ref["n_beams"] - 1.0,
        channel_means=[m / r - 1.0 for m, r in zip(means,
                                                    ref["channel_means"])])
    log(f"[compat] (a) python -m bre_tpu_torch.cli examples/fog_cube.pbrt "
        f"--kernel compat (in process), {card}: wall {wall:.3f} s for "
        f"{iters} iterations ({wall / iters:.4f} s/iter, parse, build and "
        f"PFM write included); launches {counts}; route calls {routes}")
    log(f"[compat] (a) photon paths {stats['photon_paths']} (reference "
        f"{ref['photon_paths']}); medium interactions "
        f"{stats['n_medium_scatter']} (reference {ref['n_medium_scatter']}, "
        f"{100 * rel['n_medium_scatter']:+.2f}%); beams stored "
        f"{stats['n_beams']} (reference {ref['n_beams']}, "
        f"{100 * rel['n_beams']:+.2f}%); channel means "
        f"{[round(m, 5) for m in means]} (reference "
        f"{list(ref['channel_means'])}, "
        f"{[f'{100 * r:+.2f}%' for r in rel['channel_means']]}); "
        f"overflowed walks {stats.get('n_overflow_steps')}")
    bad = (stats["photon_paths"] != ref["photon_paths"]
           or abs(rel["n_medium_scatter"]) >= CONFIG1_RTOL
           or abs(rel["n_beams"]) >= CONFIG1_RTOL
           or any(abs(r) >= CONFIG1_RTOL for r in rel["channel_means"]))
    if bad or any(counts.values()) or routes["gather_beams_packed"] or \
            not routes["gather_beams_bruteforce"]:
        raise AssertionError(
            f"config 1 compat: statistics {stats}, means {means} against the "
            f"reference's {ref} (limit {CONFIG1_RTOL}), launches {counts}, "
            f"route calls {routes}")
    # one more iteration (the first), timed as trace and camera pass
    scene = ps.build(device=dev)
    distr = light_power_distribution(scene)
    P = cfg.photonsperiteration
    rad = float(torch.tensor(cfg.initialbeamradius, dtype=torch.float32))
    (beams, _), t_trace = _timed(lambda: trace_photon_beams_compat(
        scene, distr, torch.arange(P, device=dev), cfg.maxdepth, rad))
    _, t_cam = _timed(lambda: PB.camera_pass(
        scene, ps.camera, ps.width, ps.height, beams, rad, 0, cfg, P))
    log(f"[compat] (a) iteration 0 again: trace {t_trace:.4f} s, camera pass "
        f"{t_cam:.4f} s ({card})")
    out["config1"] = dict(wall_s=wall, s_per_iter=wall / iters,
                          stats=stats, channel_means=means,
                          reference=ref, rel_err=rel, launches=counts,
                          route_calls=routes, trace_s=t_trace,
                          camera_pass_s=t_cam)
    # (b) the golden gates
    (_, st_fog), t_fog = _timed(lambda: fog_gate(dev))
    (_, st_smoke), t_smoke = _timed(lambda: smoke_gate(dev))
    log(f"[compat] (b) golden gates on the card pass: fog_golden "
        f"{t_fog:.3f} s ({st_fog['n_beams']} beams), smoke_golden "
        f"{t_smoke:.3f} s ({int(st_smoke['n_medium_scatter'])} medium "
        f"interactions, reference 1497)")
    out["golden"] = dict(fog_s=t_fog, smoke_s=t_smoke,
                         smoke_medium_interactions=int(
                             st_smoke["n_medium_scatter"]))
    # (c), (d) the volpath oracle
    for part, name in (("c", "fog_cube"), ("d", "grid_smoke")):
        make, eye, fov, vcfg, bcfg, tol, wh = ORACLES[name]
        scene = make(dev)
        cam = make_perspective_camera(tfm.look_at(eye, (0, 0, 0), (0, 1, 0)),
                                      fov, wh, wh, device=dev)
        truth, t_vol = _timed(lambda: render_volpath(scene, cam, wh, wh, vcfg))
        (est, _), t_bre = _timed(lambda: PB.render_photonbeam(
            scene, cam, wh, wh, bcfg))
        truth, est = truth.cpu().numpy(), est.cpu().numpy()
        if not (np.isfinite(truth).all() and np.isfinite(est).all()):
            raise AssertionError(f"oracle {name}: non-finite image")
        res = _check(est, truth, **tol)
        log(f"[volpath] ({part}) {name} {wh}x{wh}: volpath maxdepth "
            f"{vcfg.maxdepth} x {vcfg.spp} spp {t_vol:.3f} s "
            f"({t_vol / vcfg.spp:.5f} s/spp), BRE {bcfg.iterations} x "
            f"{bcfg.photonsperiteration} photons {t_bre:.3f} s; mean ratio "
            f"{res['mean_ratio']:.4f} (limit 1 +- {tol['mean_tol']}), "
            f"region ratios {[round(r, 3) for r in res['region_ratios']]} "
            f"(limit 1 +- {tol['region_tol']}), correlation "
            f"{res['corr']:.4f} (limit 0.95) ({card})")
        out[name] = dict(volpath_s=t_vol, volpath_s_per_spp=t_vol / vcfg.spp,
                         bre_s=t_bre, **res)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[compat] phase 30 took {out['phase_s']:.2f} s")
    return out


VSPPM_GOLDEN_PBRT = os.path.join(ROOT, "tests", "data", "vsppm_golden.pbrt")
CORNELL_PBRT = os.path.join(ROOT, "examples", "cornell_fog.pbrt")
# tests/data/vsppm_golden.pbrt's header: the C++ reference's statistics at
# 8 iterations
REF_VSPPM8 = dict(photon_paths=16_000, combined=11_073, vp_medium=3_219,
                  vp_surface=4_973)


def _cli_text_run(text, name, args, what):
    """cli.main on a scene text written to a temporary file, in this
    process: (rc, wall s, printed stats, image)."""
    import contextlib
    import io

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, f"{name}.pbrt")
        with open(scene, "w") as f:
            f.write(text)
        pfm = os.path.join(tmp, f"{name}.pfm")
        with contextlib.redirect_stdout(buf):
            rc, wall = _timed(lambda: CLI.main([scene, "-o", pfm] + args))
        if rc != 0:
            raise AssertionError(f"{what}: cli.main returned {rc}: "
                                 f"{buf.getvalue()}")
        img = IMG.read_pfm(pfm)
    if not np.isfinite(img).all():
        raise AssertionError(f"{what}: non-finite image")
    return wall, _cli_stats(buf.getvalue()), img


def phase_photon_mapping(dev, card):
    """31. The photon-mapping integrators (vsppm, photonmap) and the
    sampled integrators through the CLI; see the module docstring.  No
    kernel may launch in the phase."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_vsppm_golden import vsppm_gate
    from bre_tpu_torch.integrators.photonmap import (PhotonMapConfig,
                                                     render_photonmap,
                                                     shoot_photons)
    from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath
    from bre_tpu_torch.integrators.vsppm import VSPPMConfig, render_vsppm

    t_phase = time.perf_counter()
    out = {"card": card}
    every = KERNELS + HET_KERNELS + TWOPASS_KERNELS
    reset_launches()
    # (a) the golden gates at 32 and 64 iterations
    for iters in (32, 64):
        (_, st, rel), t = _timed(lambda: vsppm_gate(dev, iters))
        log(f"[vsppm] (a) golden gate {iters} iterations passes: {t:.3f} s "
            f"({t / iters:.4f} s/iter), combined medium interactions "
            f"{st['medium_interactions'] + st['vp_medium']} "
            f"({100 * rel['combined']:+.3f}%), channel means "
            f"{[f'{100 * r:+.2f}%' for r in rel['means']]}, region max "
            f"{rel['region_max']:.4f}, overflow {st['splat_overflow']} "
            f"({card})")
        out[f"golden{iters}"] = dict(s=t, s_per_iter=t / iters, stats=st,
                                     rel=rel)
    # (b) the CLI on the golden scene as written
    with open(VSPPM_GOLDEN_PBRT) as f:
        text = f.read()
    wall, st, img = _cli_text_run(text, "vsppm_golden", ["--kernel", "compat"],
                                  "vsppm golden scene")
    ref = REF_VSPPM8
    comb = st["medium_interactions"] + st["vp_medium"]
    rel = dict(combined=comb / ref["combined"] - 1.0,
               vp_medium=st["vp_medium"] / ref["vp_medium"] - 1.0,
               vp_surface=st["vp_surface"] / ref["vp_surface"] - 1.0)
    log(f"[vsppm] (b) cli.main vsppm_golden.pbrt --kernel compat: {wall:.3f} "
        f"s wall, {wall / 8:.4f} s/iter; paths {st['photon_paths']}, combined "
        f"{comb} ({100 * rel['combined']:+.3f}%), medium VPs "
        f"{st['vp_medium']} ({100 * rel['vp_medium']:+.2f}%), surface VPs "
        f"{st['vp_surface']} ({100 * rel['vp_surface']:+.2f}%) ({card})")
    if (st["photon_paths"] != ref["photon_paths"] or img.shape != (32, 32, 3)
            or abs(rel["combined"]) >= 0.015 or abs(rel["vp_medium"]) >= 0.02
            or abs(rel["vp_surface"]) >= 0.02):
        raise AssertionError(f"vsppm CLI statistics {st} against {ref}")
    out["cli_golden"] = dict(wall_s=wall, s_per_iter=wall / 8, stats=st,
                             rel=rel)
    # (c) physical at config 1's width, against volpath
    ps = PARSER.parse_file(FOG_CUBE_PBRT, device=dev)
    fog = ps.build(device=dev)
    W = ps.width
    cfg = VSPPMConfig(iterations=8, maxdepth=5, photonsperiteration=10_000,
                      radius=0.25)
    (img_v, st), t_v = _timed(lambda: render_vsppm(fog, ps.camera, W, W, cfg))
    truth, t_t = _timed(lambda: render_volpath(fog, ps.camera, W, W,
                                               VolPathConfig(spp=64)))
    img_v, truth = img_v.cpu().numpy(), truth.cpu().numpy()
    ratio = float(img_v.mean() / truth.mean())
    log(f"[vsppm] (c) config 1 physical, 64x64 x 8 x 10,000: {t_v:.3f} s "
        f"({t_v / 8:.4f} s/iter), overflow {st['splat_overflow']}, medium "
        f"VPs {st['vp_medium']}, surface VPs {st['vp_surface']}; volpath 64 "
        f"spp {t_t:.3f} s; ratio of means {ratio:.4f} (limit 0.6-1.6) "
        f"({card})")
    if not (np.isfinite(img_v).all() and 0.6 < ratio < 1.6):
        raise AssertionError(f"vsppm physical on config 1: ratio {ratio}")
    out["config1"] = dict(s=t_v, s_per_iter=t_v / 8, stats=st, ratio=ratio,
                          volpath_s=t_t)
    # (d) config 2's width
    ps2 = PARSER.parse_file(CORNELL_PBRT, device=dev)
    cornell = ps2.build(device=dev)
    W2 = ps2.width
    stamps = []
    cfg2 = VSPPMConfig(iterations=4, maxdepth=5, photonsperiteration=65_536,
                       radius=0.15, imagewritefrequency=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    img2, st2 = render_vsppm(cornell, ps2.camera, W2, W2, cfg2,
                             write_callback=lambda i, im: stamps.append(
                                 time.perf_counter()))
    img2 = img2.cpu().numpy()
    per_iter = np.diff([t0] + stamps)
    warm = float(per_iter[1:].mean())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    log(f"[vsppm] (d) config 2 256x256 x 4 x 65,536 photons: iterations "
        f"{[round(float(x), 4) for x in per_iter]} s, warm {warm:.4f} s/iter, "
        f"peak {peak:.3f} GiB, overflow {st2['splat_overflow']}, medium VPs "
        f"{st2['vp_medium']}, surface VPs {st2['vp_surface']}, mean "
        f"{float(img2.mean()):.5f} ({card})")
    if not (np.isfinite(img2).all() and (img2 >= 0).all()
            and img2.mean() > 0):
        raise AssertionError("vsppm on config 2: a non-finite or negative "
                             "image")
    out["config2"] = dict(iter_s=per_iter.tolist(), warm_s_per_iter=warm,
                          peak_gib=peak, stats=st2)
    # (e) photonmap on tests/test_photonmap.py's fog cube (no surfaces)
    b = SceneBuilder()
    medium = b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.0)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=medium,
          medium_outside=-1)
    b.point_light((0.0, 0.0, 0.0), (1.0,) * 3, medium=medium)
    cube = b.build(device=dev)
    cam = make_perspective_camera(tfm.look_at((0, 0, -3.5), (0, 0, 0),
                                              (0, 1, 0)), 40.0, W, W,
                                  device=dev)
    pcfg = PhotonMapConfig()
    _, t_shoot = _timed(lambda: shoot_photons(cube, pcfg))
    (img_p, st_p), t_p = _timed(lambda: render_photonmap(cube, cam, W, W,
                                                         pcfg))
    truth_p, t_tp = _timed(lambda: render_volpath(cube, cam, W, W,
                                                  VolPathConfig(spp=64)))
    img_p = img_p.cpu().numpy()
    counts = st_p["photon_counts"]
    ratio_p = float(img_p.mean() / truth_p.mean())
    log(f"[photonmap] (e) fog cube 64x64, {pcfg.nphotons} photons, "
        f"{pcfg.spp} spp, {pcfg.march_steps} march steps: {t_p:.3f} s "
        f"(shoot {t_shoot:.4f} s, {(t_p - t_shoot) / pcfg.spp:.4f} s per "
        f"pass), photons {counts}; ratio of means against volpath (64 spp, "
        f"{t_tp:.3f} s) {ratio_p:.4f} (limit 0.5-1.7) ({card})")
    if (counts["direct"] or counts["caustic"] or not counts["volume"]
            or not np.isfinite(img_p).all() or not 0.5 < ratio_p < 1.7):
        raise AssertionError(f"photonmap: counts {counts}, ratio {ratio_p}")
    out["photonmap"] = dict(s=t_p, shoot_s=t_shoot,
                            s_per_pass=(t_p - t_shoot) / pcfg.spp,
                            counts=counts, ratio=ratio_p)
    # (f) the sampled integrators through the CLI
    with open(FOG_CUBE_PBRT) as f:
        fog_text = f.read()
    spp = CLI.volpath_config(ps).spp
    for name in ("volpath", "directlighting"):
        text = fog_text.replace('Integrator "photonbeam"',
                                f'Integrator "{name}"')
        wall, _, img = _cli_text_run(text, name, [], f"cli {name}")
        rel_v = float(img.mean() / truth.mean() - 1.0)
        log(f"[volpath] (f) cli.main fog_cube.pbrt as {name} (halton, {spp} "
            f"spp, spatial): {wall:.3f} s wall, {wall / spp:.4f} s/spp; mean "
            f"{float(img.mean()):.5f}, against volpath (random, uniform, 64 "
            f"spp) {100 * rel_v:+.2f}% ({card})")
        if name == "volpath" and abs(rel_v) >= 0.05:
            raise AssertionError(f"cli volpath mean off by {rel_v}")
        out[f"cli_{name}"] = dict(wall_s=wall, s_per_spp=wall / spp,
                                  rel_mean=rel_v)
    counts = launches(every)
    if any(counts.values()):
        raise AssertionError(f"phase 31 launched kernels: {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[vsppm] phase 31 took {out['phase_s']:.2f} s")
    return out


BDPT_GOLDEN_PBRT = os.path.join(ROOT, "tests", "data", "bdpt_golden.pbrt")
BDPT_GOLDEN_PFM = os.path.join(ROOT, "tests", "data", "bdpt_golden.pfm")
# tests/test_mlt.py:27-40: the analytic sphere's equilibrium radiance is 1;
# maxdepth 5 truncates it to about 0.97, and the Metropolis variance at
# the reference's budget stays within 0.06
MLT_MEAN, MLT_ATOL = 0.97, 0.06


def _fog_shell(dev):
    """tests/test_bdpt.py:75-101: a matte shell filled with fog, lit by a
    small two-sided sphere light inside it; the camera in the fog."""
    b = SceneBuilder()
    med = b.homogeneous_medium((0.1,) * 3, (0.6,) * 3, 0.0)
    m = b.matte((0.5, 0.5, 0.5))
    b.sphere((0, 0, 0), 1.0, material=m, medium_inside=med)
    b.area_light_sphere((0.0, 0.4, 0.5), 0.15, (4.0,) * 3, material=m,
                        two_sided=True, medium=med)
    b.camera_medium = med
    return b.build(device=dev)


def _lit_sphere(dev):
    """tests/test_mlt.py:27-40: a matte sphere lit from its center by a
    point light of intensity pi."""
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1.0, material=b.matte((0.5, 0.5, 0.5)))
    b.point_light((0, 0, 0), (np.pi,) * 3)
    return b.build(device=dev)


def phase_bidirectional(dev, card):
    """32. Bidirectional path tracing, MLT and the spectral mode; see the
    module docstring.  No kernel may launch in the phase."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_bdpt_golden import bdpt_gate_check
    from bre_tpu_torch.integrators import bdpt as BD
    from bre_tpu_torch.integrators import mlt as ML
    from bre_tpu_torch.integrators.spectral import render_volpath_spectral
    from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath
    from bre_tpu_torch.lights import light_choice_pmf

    t_phase = time.perf_counter()
    out = {"card": card}
    every = KERNELS + HET_KERNELS + TWOPASS_KERNELS
    reset_launches()
    # (a) the golden gate through the CLI, at the file's own settings
    with open(BDPT_GOLDEN_PBRT) as f:
        golden_text = f.read()
    wall, _, img = _cli_text_run(golden_text, "bdpt_golden", [],
                                 "bdpt golden scene")
    rel = bdpt_gate_check(img)
    log(f"[bdpt] (a) cli.main bdpt_golden.pbrt (32x32, 64 spp, maxdepth 4): "
        f"{wall:.3f} s wall, {wall / 64:.5f} s/spp; channel means "
        f"{[f'{100 * r:+.2f}%' for r in rel['means']]} (limit 1.5%), region "
        f"max {100 * rel['region_max']:.2f}% (limit 6%) ({card})")
    out["golden"] = dict(wall_s=wall, s_per_spp=wall / 64, rel=rel)
    # (b) the same scene at 256x256 x 16 spp, twice: the same bits
    W = 256
    text = golden_text.replace("[ 32 ]", f"[ {W} ]").replace("[ 64 ]", "[ 16 ]")
    ps = PARSER.parse_string(text, device=dev)
    assert (ps.width, ps.height) == (W, W)
    scene = ps.build(device=dev)
    cfg = BD.BDPTConfig(maxdepth=4, spp=16)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = [_timed(lambda: BD.render_bdpt(scene, ps.camera, W, W, cfg))
            for _ in range(2)]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    (img_b, t_b), (img_b2, t_b2) = runs
    lanes = min(cfg.spp, BD.SAMPLE_LANES // (W * W)) * W * W
    same = bool(torch.equal(img_b, img_b2))
    log(f"[bdpt] (b) {W}x{W} x {cfg.spp} spp (maxdepth 4, "
        f"{W * W * cfg.spp:,} lanes, {lanes:,} per batch): {t_b:.3f} s, "
        f"again {t_b2:.3f} s ({t_b2 / cfg.spp:.4f} s/spp), peak {peak:.3f} "
        f"GiB, mean {float(img_b.mean()):.5f}, two runs bit-identical: "
        f"{same} ({card})")
    if not (same and bool(torch.isfinite(img_b).all())):
        raise AssertionError("bdpt at 256x256: two runs differ or the image "
                             "is not finite")
    out["size_256"] = dict(s=[t_b, t_b2], s_per_spp=t_b2 / cfg.spp,
                           lanes_per_batch=lanes, peak_gib=peak,
                           mean=float(img_b.mean()))
    # (c) medium vertices against the volpath oracle
    W = 64
    shell = _fog_shell(dev)
    cam = make_perspective_camera(tfm.look_at((0, 0, 0), (0, 0, 1),
                                              (0, 1, 0)), 60.0, W, W,
                                  device=dev)
    img_c, t_c = _timed(lambda: BD.render_bdpt(
        shell, cam, W, W, BD.BDPTConfig(maxdepth=5, spp=16)))
    truth, t_v = _timed(lambda: render_volpath(
        shell, cam, W, W, VolPathConfig(maxdepth=6, spp=64)))
    rel_c = float(img_c.mean() / truth.mean() - 1.0)
    log(f"[bdpt] (c) fog shell, sphere light, 64x64: bdpt 16 spp maxdepth 5 "
        f"{t_c:.3f} s ({t_c / 16:.4f} s/spp), volpath 64 spp maxdepth 6 "
        f"{t_v:.3f} s; means {float(img_c.mean()):.5f} / "
        f"{float(truth.mean()):.5f} ({100 * rel_c:+.2f}%, limit 10%) ({card})")
    if not (bool(torch.isfinite(img_c).all()) and abs(rel_c) < 0.1):
        raise AssertionError(f"bdpt against volpath in fog: {rel_c}")
    out["media"] = dict(s=t_c, s_per_spp=t_c / 16, volpath_s=t_v,
                        rel_mean=rel_c)
    # (d) MLT at the reference's chains and bootstrap
    sphere = _lit_sphere(dev)
    mcfg = ML.MLTConfig(maxdepth=5, bootstrapsamples=4096, chains=256,
                        mutationsperpixel=16)
    _, t_boot = _timed(lambda: ML.bootstrap(sphere, cam, W, W, mcfg,
                                            light_choice_pmf(sphere)))
    img_d, t_d = _timed(lambda: ML.render_mlt(sphere, cam, W, W, mcfg))
    steps = -(-mcfg.mutationsperpixel * W * W // mcfg.chains)
    per_step = (t_d - t_boot) / steps
    mean_d = float(img_d.mean())
    log(f"[mlt] (d) lit sphere 64x64, maxdepth 5, 4,096 bootstrap x 6 "
        f"depths, 256 chains, 16 mutations per pixel ({steps} steps): "
        f"{t_d:.3f} s (bootstrap {t_boot:.3f} s, {per_step:.4f} s per chain "
        f"step); mean {mean_d:.5f} (limit {MLT_MEAN} +- {MLT_ATOL}) ({card})")
    if not (bool(torch.isfinite(img_d).all())
            and abs(mean_d - MLT_MEAN) < MLT_ATOL):
        raise AssertionError(f"mlt on the lit sphere: mean {mean_d}")
    out["mlt"] = dict(s=t_d, bootstrap_s=t_boot, steps=steps,
                      s_per_step=per_step, mean=mean_d)
    text = golden_text.replace('Integrator "bdpt"', 'Integrator "mlt"')
    wall, _, img = _cli_text_run(text, "mlt_golden", ["--quick"],
                                 "cli mlt --quick")
    log(f"[mlt] (d) cli.main on bdpt_golden.pbrt as mlt --quick (256 "
        f"bootstrap, 256 chains, 6 mutations per pixel): {wall:.3f} s wall, "
        f"mean {float(img.mean()):.5f} against the bdpt golden's "
        f"{float(IMG.read_image(BDPT_GOLDEN_PFM).mean()):.5f} "
        f"({card})")
    out["cli_mlt"] = dict(wall_s=wall, mean=float(img.mean()))
    # (e) the spectral mode on tests/test_spectral.py's gray fog
    b = SceneBuilder()
    fog = b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.0)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.quad((-3, -3, 3), (-3, 3, 3), (3, 3, 3), (3, -3, 3),
           material=b.matte((0.5, 0.5, 0.5)))
    b.point_light((0, 0.3, 0), (1.0, 1.0, 1.0), medium=fog)
    gray = b.build(device=dev)
    cam_e = make_perspective_camera(tfm.look_at((0, 0, -3.5), (0, 0, 0),
                                                (0, 1, 0)), 40.0, W, W,
                                    device=dev)
    vcfg = VolPathConfig(maxdepth=4, spp=16, sampler="stratified")
    rgb, t_rgb = _timed(lambda: render_volpath(gray, cam_e, W, W, vcfg))
    spec, t_spec = _timed(lambda: render_volpath_spectral(gray, cam_e, W, W,
                                                          vcfg))
    ratio = float(spec.mean() / rgb.mean())
    log(f"[spectral] (e) gray fog 64x64 x 16 spp stratified, maxdepth 4: "
        f"spectral {t_spec:.3f} s against RGB {t_rgb:.3f} s "
        f"({t_spec / t_rgb:.1f}x); ratio of means {ratio:.5f} (limit 1 +- "
        f"0.02) ({card})")
    if not (bool(torch.isfinite(spec).all()) and abs(ratio - 1.0) < 0.02):
        raise AssertionError(f"spectral against RGB: ratio {ratio}")
    out["spectral"] = dict(s=t_spec, rgb_s=t_rgb, ratio=ratio)
    counts = launches(every)
    if any(counts.values()):
        raise AssertionError(f"phase 32 launched kernels: {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[bdpt] phase 32 took {out['phase_s']:.2f} s")
    return out


# ---------------------------------------------------------------------------
# The sparse tier in its regime (phase 33)
# ---------------------------------------------------------------------------

# The reference's progressive radius r <- r (i + alpha) / (i + 1)
# (bre_tpu/integrators/photonbeam.py:542) at its default alpha, 0.5, read at
# these iterations; config 2's own alpha (0.7) beside it.  A sweep is in the
# sparse regime at or under REGIME_SHARE of its block grid live: the default
# cap's own bound before its clamp at 2^17 ids (integrators/photonbeam.py).
REGIME_ALPHA = 0.5
REGIME_ITERS = (1, 16, 64, 256)
REGIME_SHARE = 0.25
REGIME_SEED = 33
# ray tiles of the regime sweep held against the plain versions: the
# heaviest and a median one (the whole sweep would take minutes)
REGIME_PLAIN_TILES = 2


def radius_at(r0, alpha, it):
    """The progressive radius of iteration ``it`` (0 = the first)."""
    r = r0
    for i in range(it):
        r = r * (i + alpha) / (i + 1)
    return r


def capture_full_sweeps(scene, cam, size, cfg):
    """One iteration on the packed route with the dense kernel only
    (gather="pallas"), recording each full-film sweep's inputs (rays,
    beams, scalars, mask)."""
    rec = []
    orig = _event_timed(BG, "gather_forward", rec)
    try:
        PB.render_photonbeam(scene, cam, size, size, cfg)
    finally:
        BG.gather_forward = orig
    torch.cuda.synchronize()
    return [a for _, _, _, a in rec if a[0].shape[0] == size * size // BG.TILE]


def at_radius(rays, beams, scal, r):
    """One sweep's beams, scalars and block mask with the beam and camera
    radius set to r (the valid beams' BF_RAD, scalars[0, 0])."""
    r = torch.tensor(r, dtype=torch.float32, device=beams.device)
    b = beams.clone()
    b[:, G.BF_RAD] = torch.where(b[:, G.BF_VALID] > 0, r, b[:, G.BF_RAD])
    sc = scal.clone()
    sc[0, 0] = r
    a0 = rays[:, G.RF_A0:G.RF_A0 + 3].transpose(1, 2).reshape(-1, 3)
    a1 = rays[:, G.RF_A1:G.RF_A1 + 3].transpose(1, 2).reshape(-1, 3)
    return b, sc, BG._block_overlap_mask(b, a0, a1, BG.TILE, r)


def modelled_tail(work, slots):
    """Makespan of blocks of the given work, started in list order on
    ``slots`` resident block slots (each next block on the first free
    slot), over the ideal total / slots.  A model of the block scheduler,
    not a measurement."""
    import heapq
    free = [0.0] * slots
    for w in work:
        heapq.heappush(free, heapq.heappop(free) + w)
    return max(free) / max(sum(work) / slots, 1e-30)


def regime_work(mask, scal):
    """The regime mask's work per block of the sparse kernels' launches:
    listed tiles per chunk (the d_beams sweep, one block per chunk), listed
    chunks per (tile, split) (the ray-side sweeps), and the modelled tails
    of launching them in index order or in order of work."""
    n_chunks, n_tiles = mask.shape
    live = G._live_chunks(n_chunks, BG.CHUNK, scal[0, 3], mask.device)
    m = (mask > 0) & live[:, None]
    per_chunk = m.sum(1).cpu().numpy().astype(np.float64)
    n_splits = G.split_count(n_tiles, n_chunks)
    b = G.split_bounds(scal[0, 3], n_chunks, n_splits).cpu().tolist()
    cm = torch.cat([torch.zeros((1, n_tiles), dtype=torch.int64,
                                device=mask.device), m.cumsum(0)], 0)
    per_split = torch.stack([cm[b[s + 1]] - cm[b[s]] for s in
                             range(n_splits)], 1).reshape(-1)
    per_split = per_split.cpu().numpy().astype(np.float64)  # tile-major
    out = dict(n_splits=n_splits,
               chunks_listed=int((per_chunk > 0).sum()),
               tiles_per_chunk_max=int(per_chunk.max()),
               tiles_per_chunk_mean=float(per_chunk[per_chunk > 0].mean()),
               split_blocks=int(per_split.size),
               split_blocks_empty=int((per_split == 0).sum()),
               chunks_per_split_max=int(per_split.max()),
               chunks_per_split_mean=float(per_split[per_split > 0].mean()))
    for name, work, slots in (("d_beams", per_chunk, 132 * 3),
                              ("ray_side", per_split, 132 * 4)):
        out[f"{name}_tail_index_order"] = modelled_tail(work, slots)
        out[f"{name}_tail_work_order"] = modelled_tail(
            np.sort(work)[::-1], slots)
    return out


def regime_point(dev):
    """Config 2's full-film sweeps at the regime radii: their live shares,
    the default cap's pick, and the first sweep at or under REGIME_SHARE
    (config 2's heaviest sweep first; bench.py's fog box where config 2
    never gets there).  Returns (log dict, (rays, beams, scal, mask) or
    None, what)."""
    scenes = (("config 2", cornell_fog(dev), cornell_camera(dev, SIZE), 0.12,
               PHOTONS),
              ("fog box", *fog_box(dev, SPEC_WH), 0.1, SPEC_PHOTONS))
    out = {}
    for what, scene, cam, r0, photons in scenes:
        cfg = PB.PhotonBeamConfig(
            iterations=1, maxdepth=MAXDEPTH, photonsperiteration=photons,
            initialbeamradius=r0, gather="pallas", grad_geometry=False)
        sweeps = capture_full_sweeps(scene, cam, SIZE, cfg)
        n_chunks, n_tiles = sweeps[0][3].shape
        cap = PB.default_sparse_cap(photons * (MAXDEPTH + 2),
                                    n_tiles * BG.TILE)
        rows, first_pick, point = [], None, None
        for alpha in (REGIME_ALPHA, 0.7):
            for it in REGIME_ITERS:
                r = radius_at(r0, alpha, it)
                lives = []
                for rays, beams, scal, _ in sweeps:
                    _, _, mask = at_radius(rays, beams, scal, r)
                    lives.append(int((mask > 0).sum()))
                    del mask
                shares = [n / (n_chunks * n_tiles) for n in lives]
                picks = [n <= cap for n in lives]
                rows.append(dict(alpha=alpha, iteration=it, radius=r,
                                 live_blocks=lives, live_share=shares,
                                 default_cap_picks_sparse=picks))
                log(f"[regime] {what}, alpha {alpha}, iteration {it}: radius "
                    f"{r:.6g}; live share of the {n_chunks} x {n_tiles} "
                    f"block grid per full-film sweep "
                    f"{[round(x, 4) for x in shares]}; the default cap "
                    f"({cap} ids) picks sparse on {sum(picks)} of "
                    f"{len(picks)}")
                if alpha == REGIME_ALPHA and any(picks) and first_pick is None:
                    first_pick = it
                if (alpha == REGIME_ALPHA and point is None
                        and min(shares) <= REGIME_SHARE):
                    k = max((i for i in range(len(lives))
                             if shares[i] <= REGIME_SHARE),
                            key=lambda i: lives[i])
                    point = (it, r, k, shares[k])
        log(f"[regime] {what}: the default cap first picks the sparse kernel "
            f"at iteration {first_pick if first_pick is not None else 'none'}"
            f" of {REGIME_ITERS} (alpha {REGIME_ALPHA})")
        out[what] = dict(cap=cap, rows=rows, first_sparse_pick=first_pick,
                         grid=[n_chunks, n_tiles])
        if point is not None:
            it, r, k, share = point
            rays, beams, scal, _ = sweeps[k]
            beams, scal, mask = at_radius(rays, beams, scal, r)
            out["point"] = dict(scene=what, iteration=it, radius=r, sweep=k,
                                live_share=share)
            return out, (rays, beams, scal, mask), what
        del sweeps
    return out, None, None


def phase_sparse_regime(dev, kernels):
    """Phase 33.  Rows 2 and 4 against rows 1 and 3 on one full-film sweep
    of the sparse regime (its mask at most REGIME_SHARE live): each timed
    with CUDA events (mean of 3 after a warm-up) beside the bound of the
    listed blocks; dense and sparse bit for bit; the sparse kernels against
    their plain versions on REGIME_PLAIN_TILES of its ray tiles.  Adds the
    regime figures to rows 2 and 4 of ``kernels``."""
    t0 = time.perf_counter()
    out, sweep, what = regime_point(dev)
    if sweep is None:
        log("[regime] no scene's full-film sweep reaches "
            f"{REGIME_SHARE:.0%} live by iteration {REGIME_ITERS[-1]}: "
            "rows 2 and 4 are timed at the cap-at-grid sweeps only")
        out["seconds"] = time.perf_counter() - t0
        return out
    rays, beams, scal, mask = sweep
    n_chunks, n_tiles = mask.shape
    cap = n_chunks * n_tiles // 4
    idx_t, n_live = G.sparse_block_ids(mask, cap)
    idx_c, _ = GB.sparse_block_ids_chunk_major(mask, cap)
    n_live = int(n_live)
    work = regime_work(mask, scal)
    log(f"[regime] {what} sweep at iteration {out['point']['iteration']} "
        f"(radius {out['point']['radius']:.6g}): {n_live} live blocks of "
        f"{mask.numel()} ({n_live / mask.numel():.2%}); list cap {cap}; "
        f"work per launched block {json.dumps(work)}")
    gen = torch.Generator(device="cpu").manual_seed(REGIME_SEED)
    ct = torch.rand((n_tiles, GB.NDR, BG.TILE), generator=gen) * 2 - 1
    ct[:, 3:] = 0.0
    ct = ct.to(dev)
    in_range, _ = pairs_in_range(rays, beams, scal, mask)
    geom = n_live * BG.TILE * BG.CHUNK * GEOM_OPS
    fwd_bytes = (nbytes(rays, beams, scal)
                 + n_tiles * G.OUT_ROWS * BG.TILE * 4)
    bwd_bytes = nbytes(rays, beams, scal, ct) + nbytes(rays[:, :GB.NDR], beams)
    cases = [(G.gather_forward, None,
              lambda: G.gather_forward(rays, beams, scal, mask), FWD_IN_OPS,
              fwd_bytes + nbytes(mask)),
             (G.gather_sparse, None,
              lambda: G.gather_sparse(rays, beams, scal, idx_t), FWD_IN_OPS,
              fwd_bytes + nbytes(idx_t))]
    for extras in (False, True):
        ops = BWD_IN_OPS + (BWD_EXTRAS_OPS if extras else 0)
        cases += [
            (GB.gather_backward_fused, extras,
             lambda e=extras: GB.gather_backward_fused(rays, beams, scal, ct,
                                                       mask, e),
             ops, bwd_bytes + nbytes(mask)),
            (GB.gather_backward_sparse, extras,
             lambda e=extras: GB.gather_backward_sparse(
                 rays, beams, scal, ct, idx_t, idx_c, e),
             ops, bwd_bytes + nbytes(idx_t, idx_c))]
    timed, outs = {}, {}
    for wrapper, extras, fn, in_ops, n_bytes in cases:
        name = wrapper.__name__
        first = fn()
        again = fn()
        same = (torch.equal(first, again) if torch.is_tensor(first) else
                all(torch.equal(a, b) for a, b in zip(first, again)))
        if not same:
            raise AssertionError(f"{name} (regime, extras={extras}): two "
                                 "runs differ")
        ms, _ = cuda_ms(fn, 3, warm=False)
        bound_ms, bound_by = bound(geom + in_range * in_ops, n_bytes)
        key = name if extras is None else f"{name} extras={extras}"
        timed[key] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                          share=bound_ms / ms,
                          **launched_grid(wrapper))
        outs[key] = first
        log(f"[regime] {key}: {ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of it; launched "
            f"{json.dumps(launched_grid(wrapper))}; two runs "
            "bit-identical")
    pairs = [("gather_forward", "gather_sparse")] + [
        (f"gather_backward_fused extras={e}",
         f"gather_backward_sparse extras={e}") for e in (False, True)]
    for a, b in pairs:
        oa, ob = outs[a], outs[b]
        same = (torch.equal(oa, ob) if torch.is_tensor(oa) else
                all(torch.equal(x, y) for x, y in zip(oa, ob)))
        if not same:
            raise AssertionError(f"regime sweep: {a} and {b} differ")
        log(f"[regime] {a} and {b}: bit for bit; sparse / dense time "
            f"{timed[b]['ms'] / timed[a]['ms']:.4f}")
    del outs
    # the sparse kernels against their plain versions on a few ray tiles
    per_tile = (mask > 0).sum(0)
    order = torch.argsort(per_tile, descending=True, stable=True)
    tiles = torch.stack([order[0], order[n_tiles // 2]])
    sub_r, sub_m = rays[tiles].contiguous(), mask[:, tiles].contiguous()
    sub_ct = ct[tiles].contiguous()
    sub_cap = int((sub_m > 0).sum())
    s_idx, _ = G.sparse_block_ids(sub_m, sub_cap)
    s_idc, _ = GB.sparse_block_ids_chunk_major(sub_m, sub_cap)
    res = G.gather_sparse(sub_r, beams, scal, s_idx)
    ref = G.gather_sparse_ref(sub_r, beams, scal, s_idx)
    fwd_err = float((res - ref).abs().max())
    if not torch.allclose(res, ref, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"gather_sparse disagrees with its plain version "
                             f"on the regime sweep's tiles ({fwd_err})")
    errs = {}
    for extras in (False, True):
        o = GB.gather_backward_sparse(sub_r, beams, scal, sub_ct, s_idx,
                                      s_idc, extras)
        r = GB.gather_backward_sparse_ref(sub_r, beams, scal, sub_ct, s_idx,
                                          s_idc, extras)
        errs[f"extras={extras}"] = {k: v[1] for k, v in _bwd_close(
            o, r, f"gather_backward_sparse (regime tiles, extras={extras})"
        ).items()}
    log(f"[regime] on ray tiles {tiles.tolist()} ({sub_cap} live blocks): "
        f"gather_sparse max abs err {fwd_err:.3e} (allclose rtol {RTOL}); "
        f"gather_backward_sparse per cotangent max |diff| / max|ref| "
        f"{json.dumps(errs)}")
    parts = backward_kernel_ms({
        "sparse": ("gather_backward_sparse",
                   (rays, beams, scal, ct, idx_t, idx_c, False)),
        "dense": ("gather_backward_fused",
                  (rays, beams, scal, ct, mask, False))})
    log(f"[regime] device ms per kernel (torch.profiler, mean of "
        f"{PROFILE_REPS}, want_extras=False): "
        + json.dumps({k: {n: round(v, 3) for n, v in p.items()}
                      for k, p in parts.items()}))
    for k in kernels:
        key = {"gather_sparse": "gather_sparse",
               "gather_backward_sparse":
                   "gather_backward_sparse extras=False"}.get(k["name"])
        if key:
            dense = key.replace("sparse", "fused" if "backward" in key
                                else "forward")
            k["regime"] = dict(timed[key], dense_ms=timed[dense]["ms"],
                               **out["point"])
            k["sweeps"]["regime"] = timed[key]
    out.update(live_blocks=n_live, pairs_in_range=in_range, work=work,
               timed=timed, plain_err=dict(fwd=fwd_err, bwd=errs),
               kernels_ms=parts, seconds=time.perf_counter() - t0)
    log(f"[regime] phase 33 took {out['seconds']:.1f} s")
    return out


GLASS_PBRT = os.path.join(ROOT, "examples", "glass_caustics.pbrt")
BSDF_LANES = 1 << 20


def _spread(run, inputs, names):
    """run(*inputs) -> dict of CPU outputs, and how far each float output
    moves, lane by lane, when each input x moves by up to eight float32
    ulps of max(|x|, 1) (tests/test_torch_materials.py's conditioning
    bound), and the lanes whose bool outputs or lobe that moves flip."""
    out = run(*inputs)
    spread = {k: torch.zeros(out[k].shape[0]) for k in names}
    flips = torch.zeros(out["f"].shape[0], dtype=torch.bool)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        moved = [x + torch.randint(-8, 9, x.shape, generator=g)
                 .to(torch.float32) * 2.0 ** -23 * torch.clamp_min(x.abs(), 1.0)
                 for x in inputs]
        o = run(*moved)
        for k in names:
            d = (o[k] - out[k]).abs()
            spread[k] = torch.maximum(spread[k], d.amax(-1) if d.dim() == 2
                                      else d)
        for k in ("specular", "valid"):
            if k in out:
                flips |= o[k] != out[k]
        if "wi" in out:
            flips |= (o["wi"] - out["wi"]).abs().amax(-1) > 1e-3
    return out, spread, flips


def _bsdf_card_vs_cpu(scenes, ids, R, textured, seed, card_dev):
    """Every material's sample_bsdf (both modes) and eval_bsdf (at random
    and at the sampled directions) on R lanes on the card against the same
    calls on the CPU: wi, f and pdf within rtol 1e-5 / atol 1e-6 plus four
    times the CPU's own spread under 1-8 ulp input moves; specular and
    valid equal but on the lanes that move flips (at most 0.1%).  Returns
    (max |card - cpu| / max(|cpu|, 1) over f, the flipped lanes, the logged
    outliers)."""
    g = torch.Generator().manual_seed(seed)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    n = unit(torch.randn((R, 3), generator=g))
    wo = unit(torch.randn((R, 3), generator=g))
    k = R // 16  # grazing lanes
    t = unit(torch.cross(n[:k], torch.randn((k, 3), generator=g), dim=-1))
    wo[:k] = unit(t + 1e-3 * n[:k])
    wi = unit(torch.randn((R, 3), generator=g))
    u = torch.rand((R, 2), generator=g)
    tan = torch.randn((R, 3), generator=g)
    p = torch.rand((R, 3), generator=g) * 4.0 - 2.0
    uv = torch.rand((R, 2), generator=g) * 3.0 - 1.0
    names = [m for m in ids if m.endswith("_tex") == textured]
    pick = torch.tensor([ids[m] for m in names])
    mat = pick[torch.randint(0, len(names), (R,), generator=g)]
    mat[torch.rand(R, generator=g) < 0.1] = -1
    worst, flipped = 0.0, 0

    def calls(dev):
        sc = scenes["cpu" if dev.type == "cpu" else "card"]

        def kw(p_, uv_, t_):
            d = dict(tangent=t_)
            if textured:
                d.update(textures=sc.textures, p=p_, uv=uv_)
            return d

        def sample(mode):
            def run(n_, wo_, u_, p_, uv_, t_):
                b = MAT.sample_bsdf(sc.materials, mat.to(dev), n_.to(dev),
                                    wo_.to(dev), u_.to(dev), mode=mode,
                                    **kw(p_.to(dev), uv_.to(dev), t_.to(dev)))
                return {f: v.cpu() for f, v in b._asdict().items()}
            return run

        def evaluate(n_, wo_, w_, p_, uv_, t_):
            ekw = kw(p_.to(dev), uv_.to(dev), t_.to(dev))
            del ekw["tangent"]  # no ported lobe's eval reads it
            f, pdf = MAT.eval_bsdf(sc.materials, mat.to(dev), n_.to(dev),
                                   wo_.to(dev), w_.to(dev), **ekw)
            return dict(f=f.cpu(), pdf=pdf.cpu())
        return sample, evaluate

    cpu_sample, cpu_eval = calls(torch.device("cpu"))
    card_sample, card_eval = calls(card_dev)

    outliers = []
    M_cpu = scenes["cpu"].materials
    mi = mat.clamp_min(0)
    ggx = (M_cpu.mtype >= 3) & (M_cpu.mtype <= 5)  # metal, plastic, uber
    a_mat = torch.where(ggx, M_cpu.roughness.clamp(1e-3, 1.0),
                        torch.full_like(M_cpu.roughness, float("inf")))
    alpha = a_mat[mi].double()  # inf: no GGX lobe, so no D to condition
    for sub in (M_cpu.mix_m1, M_cpu.mix_m2):  # a mix: its narrower lobe
        alpha = torch.where(M_cpu.mtype[mi] == 8, torch.minimum(
            alpha, a_mat[sub[mi].clamp_min(0)].double()), alpha)

    def ggx_rtol(w):
        """4 float32 ulps of c^2 times the condition number of GGX's D at
        the half vector of (wo, w): near a narrow lobe's peak D's
        denominator cancels to about alpha^2, and the rounding of c^2
        itself (not an input move) sets the error (measured on the card:
        a metal lane at roughness 0.01, f 345.128 against 345.519)."""
        ns = torch.where(((n * wo).sum(-1) < 0)[:, None], -n, n).double()
        h = wo.double() + w.double()
        h = h / h.norm(dim=-1, keepdim=True).clamp_min(1e-30)
        c2 = (h * ns).sum(-1) ** 2
        a2 = alpha.clamp_max(1.0) ** 2
        kappa = 2.0 * (c2 * (a2 - 1.0)).abs() / (c2 * (a2 - 1.0) + 1.0).abs(
        ).clamp_min(1e-30)
        return torch.where(alpha.isinf(), 0.0, kappa * 2.0 ** -21).float()

    def close(name, a, b, spread, skip, w=None):
        """Lanes outside the bound (rtol 1e-5 plus ``ggx_rtol`` of the
        lane's directions, atol 1e-6, four times the CPU's spread) are
        logged with their inputs; at most one in 100,000 may be, and none
        of those by more than the larger of 1e-3 (relative to max(|cpu|,
        1)) and 16 times the spread: the card's sinf, cosf, sqrtf and
        division round differently from the CPU's, which two draws of
        input moves need not always show (a mixed plastic lane near its
        GGX peak: pdf 29,588 on the card, 10,142 on the CPU, spread
        3,927)."""
        if a.dtype == torch.bool:
            bad = (a != b) & ~skip
            far = bad
        else:
            sp = spread[:, None] if a.dim() == 2 else spread
            rt = 1e-5 + (ggx_rtol(w) if w is not None else 0.0)
            rt = rt[:, None] if a.dim() == 2 and w is not None else rt
            d = (a - b).abs()
            bad = d > 1e-6 + 4.0 * sp + rt * b.abs()
            far = d > torch.maximum(1e-3 * torch.clamp_min(b.abs(), 1.0),
                                    16.0 * sp + 4.0 * rt * b.abs())
            if a.dim() == 2:
                bad, far = bad.any(-1), far.any(-1)
            bad, far = bad & ~skip, far & ~skip
        for i in bad.nonzero()[:4, 0].tolist():
            outliers.append(dict(
                what=name, lane=i, material=int(mat[i]), card=a[i].tolist(),
                cpu=b[i].tolist(), spread=None if spread is None
                else float(spread[i]), n=n[i].tolist(), wo=wo[i].tolist(),
                u=u[i].tolist(), tangent=tan[i].tolist(),
                w=None if w is None else w[i].tolist()))
            log(f"[surface] (c) outlier: {outliers[-1]}")
        if int(bad.sum()) > R // 100000 or bool((far & bad).any()):
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(f"bsdf {name}, card vs CPU: {int(bad.sum())} "
                                 f"lanes differ, lane {i}: {a[i]} vs {b[i]} "
                                 f"(material {int(mat[i])})")

    def rel_err(a, b):
        return float(((a - b).abs() / torch.clamp_min(b.abs(), 1.0)).max())

    args = [n, wo, u, p, uv, tan]
    for mode in (MAT.MODE_RADIANCE, MAT.MODE_IMPORTANCE):
        ref, spread, flips = _spread(cpu_sample(mode), args, ("wi", "f", "pdf"))
        card = card_sample(mode)(*args)
        skip = flips & (mat >= 0)
        if int(skip.sum()) > R // 1000:
            raise AssertionError(f"bsdf: {int(skip.sum())} lanes at a branch "
                                 f"threshold of {R}")
        for key in ("specular", "valid", "wi", "f", "pdf"):
            close(f"sample {key} mode {mode}", card[key], ref[key],
                  spread.get(key, None), skip,
                  ref["wi"] if key in ("f", "pdf") else None)
        worst = max(worst, rel_err(card["f"], ref["f"]))
        flipped += int(skip.sum())
    # eval has no mode, and the sampled directions are the same in both
    for w in (wi, ref["wi"]):
        e, es, _ = _spread(cpu_eval, [n, wo, w, p, uv, tan], ("f", "pdf"))
        ec = card_eval(n, wo, w, p, uv, tan)
        none = torch.zeros(R, dtype=torch.bool)
        close("eval f", ec["f"], e["f"], es["f"], none, w)
        close("eval pdf", ec["pdf"], e["pdf"], es["pdf"], none, w)
        worst = max(worst, rel_err(ec["f"], e["f"]))
    return worst, flipped, outliers


def phase_surface_materials(dev, card):
    """34. The analytic surface materials and the texture table: (a)
    BASELINE config 4 through cli.main on examples/glass_caustics.pbrt as
    written (256x256, 12 iterations x 100,000 photons, maxdepth 6, radius
    0.12, the default route), counted: the forward kernels must launch and
    the image be finite; wall s, s/iter, the photon statistics, then the
    same config through render_photonbeam with each iteration timed; (b)
    the 8-iteration caustics golden gate (tests/test_torch_caustics_golden
    .py's caustics_gate: interactions within 0.2% of 111,394, channel means
    within 1.5%, region p90 under 0.12 and max under 0.5); (c) every
    material's sample_bsdf and eval_bsdf at 2^20 lanes (the textured ones
    at 2^16) on the card against the CPU; (d) a textured volpath render with
    texture_filter=True on the card against the CPU (64x64, 4 spp: means
    within 1e-3); (e) MLT, whose chain step is a CUDA graph, on the glass,
    mirror, metal and plastic scene: a finite image."""
    import contextlib
    import io

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_caustics_golden import caustics_gate
    from torch_parity import (IMAGE_LOOK, SURFACE_FOV, SURFACE_LOOK,
                              every_material, image_scene, surface_scene)
    from bre_tpu_torch.integrators import mlt as ML
    from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath

    t_phase = time.perf_counter()
    out = {"card": card}
    # (a) config 4 through the CLI
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        pfm = os.path.join(tmp, "glass_caustics.pfm")
        reset_launches()
        with contextlib.redirect_stdout(buf):
            rc, wall = _timed(lambda: CLI.main([GLASS_PBRT, "-o", pfm]))
        counts, routes = launches(FWD_KERNELS), route_calls()
        if rc != 0:
            raise AssertionError(f"cli on glass_caustics.pbrt returned {rc}: "
                                 f"{buf.getvalue()}")
        img = torch.from_numpy(IMG.read_pfm(pfm))
    stats = _cli_stats(buf.getvalue())
    ps = PARSER.parse_file(GLASS_PBRT, device=dev)
    cfg = CLI.photonbeam_config(ps)
    size, iters = ps.width, cfg.iterations
    mean = check_image(img, size, "config-4 CLI render")
    log(f"[surface] (a) python -m bre_tpu_torch.cli examples/glass_caustics"
        f".pbrt (in process), {card}: {size}x{size}, {iters} iterations x "
        f"{cfg.photonsperiteration} photons, maxdepth {cfg.maxdepth}, radius "
        f"{cfg.initialbeamradius}, kernel {cfg.kernel}, gather={cfg.gather}: "
        f"wall {wall:.3f} s ({wall / iters:.4f} s/iter, parse, build and PFM "
        f"write included); statistics {stats}; image mean {mean:.6f}, finite;"
        f" launches {counts}; route calls {routes}")
    if sum(counts.values()) <= 0 or counts["gather_forward"] <= 0 or \
            routes["gather_beams_bruteforce"] <= 0:
        raise AssertionError(f"config 4: the forward kernels must launch on "
                             f"the default route: {counts}, {routes}")
    scene = ps.build(device=dev)
    _, st, per_iter = timed_render(scene, ps.camera, size, dataclasses.replace(
        cfg, imagewritefrequency=1))
    warm = float(np.mean(per_iter[1:]))
    log(f"[surface] (a) the same config through render_photonbeam: s/iter "
        f"{[round(t, 4) for t in per_iter]} (warm, iterations 2-{iters}: "
        f"{warm:.4f}); valid beams/iter {st['n_beams'] / iters:.0f}, medium "
        f"interactions/iter {int(st['n_medium_scatter']) / iters:.0f} "
        f"({card})")
    # one more iteration, phase by phase (phase 20's breakdown)
    phases, sweeps = [], []
    saved = [(PB, n, _host_timed(PB, n, phases))
             for n in ("trace_photon_beams", "compact_beams", "camera_pass")]
    saved.append((BG, "gather_forward", _event_timed(BG, "gather_forward",
                                                     sweeps)))
    try:
        _, _, it1 = timed_render(scene, ps.camera, size, dataclasses.replace(
            cfg, iterations=iters + 1, startiteration=iters,
            enditeration=iters + 1))
    finally:
        for module, name, orig in saved:
            setattr(module, name, orig)
    torch.cuda.synchronize()
    by = {n: sum(t for m, t in phases if m == n) for n, _ in phases}
    kernel_ms = [e0.elapsed_time(e1) for _, e0, e1, _ in sweeps]
    breakdown = dict(iteration_s=it1[0], trace_s=by["trace_photon_beams"],
                     compact_s=by["compact_beams"],
                     camera_pass_s=by["camera_pass"], kernel_ms=kernel_ms,
                     walk_outside_kernels_s=by["camera_pass"]
                     - sum(kernel_ms) / 1e3)
    log(f"[surface] (a) iteration {iters + 1}: {it1[0]:.4f} s; trace "
        f"{breakdown['trace_s']:.4f} s, compaction "
        f"{breakdown['compact_s']:.4f} s, camera pass "
        f"{breakdown['camera_pass_s']:.4f} s, of which the forward kernel "
        f"{sum(kernel_ms):.3f} ms over {len(kernel_ms)} sweeps "
        f"{[round(m, 3) for m in kernel_ms]} ({card})")
    out["config4"] = dict(wall_s=wall, s_per_iter=wall / iters,
                          warm_s_per_iter=warm, per_iter_s=per_iter,
                          stats=stats, image_mean=mean, launches=counts,
                          route_calls=routes, breakdown=breakdown,
                          n_beams_per_iter=st["n_beams"] / iters)
    # (b) the caustics golden gate
    (img_b, st_b), t_b = _timed(lambda: caustics_gate(dev, 8))
    log(f"[surface] (b) caustics golden gate, 8 iterations x 20,000 photons "
        f"on the card: {t_b:.3f} s, {int(st_b['n_medium_scatter'])} medium "
        f"interactions (reference 111,394), image mean {img_b.mean():.6f} "
        f"({card})")
    out["caustics_gate"] = dict(s=t_b, medium_interactions=int(
        st_b["n_medium_scatter"]))
    # (c) the materials, card against CPU
    scenes = {}
    for d, devd in (("cpu", torch.device("cpu")), ("card", dev)):
        b = SceneBuilder()
        ids = every_material(b)
        scenes[d] = b.build(device=devd)
    (err, flipped, odd), t_c = _timed(lambda: _bsdf_card_vs_cpu(
        scenes, ids, BSDF_LANES, False, 5, dev))
    (err_t, flipped_t, odd_t), t_ct = _timed(lambda: _bsdf_card_vs_cpu(
        scenes, ids, BSDF_LANES >> 4, True, 6, dev))
    log(f"[surface] (c) sample_bsdf and eval_bsdf of {len(ids)} materials, "
        f"2^20 lanes (textured: 2^16), both modes, card against CPU: agree "
        f"(max |f| difference / max(|f|, 1) {max(err, err_t):.3e}; "
        f"{flipped + flipped_t} "
        f"lanes at a branch threshold skipped; {len(odd) + len(odd_t)} "
        f"logged outside the bound); {t_c + t_ct:.3f} s")
    out["bsdf"] = dict(max_rel_err_f=max(err, err_t),
                       threshold_lanes=flipped + flipped_t,
                       outliers=odd + odd_t, s=t_c + t_ct)
    # (d) texture_filter volpath, card against CPU
    wh = 64
    vcfg = VolPathConfig(maxdepth=3, spp=4, texture_filter=True)
    imgs = {}
    for d in ("card", "cpu"):
        devd = dev if d == "card" else torch.device("cpu")
        sc = image_scene(SceneBuilder(), device=devd)
        cam = make_perspective_camera(tfm.look_at(*IMAGE_LOOK), 40.0, wh, wh,
                                      device=devd)
        imgs[d], t = _timed(lambda: render_volpath(sc, cam, wh, wh, vcfg))
        imgs[d] = imgs[d].cpu()
        out[f"texture_filter_{d}_s"] = t
    m_card = check_image(imgs["card"], wh, "texture_filter volpath (card)")
    m_cpu = check_image(imgs["cpu"], wh, "texture_filter volpath (CPU)")
    rel_d = abs(m_card / m_cpu - 1.0)
    log(f"[surface] (d) volpath texture_filter=True on image maps, {wh}x{wh}"
        f" x {vcfg.spp} spp: card {out['texture_filter_card_s']:.3f} s, CPU "
        f"{out['texture_filter_cpu_s']:.3f} s; means {m_card:.6f} / "
        f"{m_cpu:.6f} (rel {rel_d:.2e}, limit 1e-3) ({card})")
    if rel_d >= 1e-3:
        raise AssertionError(f"texture_filter volpath: card mean {m_card} vs "
                             f"CPU {m_cpu}")
    out["texture_filter"] = dict(mean_card=m_card, mean_cpu=m_cpu, rel=rel_d)
    # (e) MLT's CUDA-graph chain step on a scene with glass
    wm = 32
    sc = surface_scene(SceneBuilder(), textured=False, device=dev)
    cam = make_perspective_camera(tfm.look_at(*SURFACE_LOOK), SURFACE_FOV, wm,
                                  wm, device=dev)
    mcfg = ML.MLTConfig(maxdepth=4, bootstrapsamples=1024, chains=64,
                        mutationsperpixel=4)
    img_e, t_e = _timed(lambda: ML.render_mlt(sc, cam, wm, wm, mcfg))
    m_e = check_image(img_e.cpu(), wm, "mlt on the surface scene")
    log(f"[surface] (e) render_mlt on the glass/mirror/metal/plastic scene "
        f"{wm}x{wm}, 64 chains, 4 mutations per pixel: {t_e:.3f} s, mean "
        f"{m_e:.6f}, finite ({card})")
    out["mlt"] = dict(s=t_e, mean=m_e)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[surface] phase 34 took {out['phase_s']:.2f} s")
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--profile-backward":
        return profile_backward(sys.argv[2])
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
    report["ptxas"] = ptxas_summary(cuda_build.build_log or "")
    for kernel, use in report["ptxas"].items():
        log(f"[ptxas] {kernel}: {use}")
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
    del bench_sweeps
    report["grad_consistency"] = phase_grad_consistency(dev)
    img_smoke, report["smoke"] = phase_smoke_render(dev)
    report["smoke_counted"] = phase_smoke_counted(dev, img_smoke)
    kernels += phase_smoke_parity(dev)
    report["smoke_steps"], smoke_sweeps = phase_smoke_steps(dev)
    kernels.append(phase_smoke_bwd_parity(smoke_sweeps))
    del smoke_sweeps
    report["smoke_trainer"] = phase_smoke_trainer(dev)
    report["smoke_consistency"] = phase_smoke_consistency(dev)
    report["cli_config2"], route_sweep, img_cli2 = phase_cli_config2(dev)
    report["cli_config3"] = phase_cli_config3(dev, img_smoke)
    del img_smoke
    report["attached_step"], captured = phase_attached_step(dev)
    report["analytic_bwd"], twopass_row, gather22 = phase_analytic_bwd(
        captured)
    del captured
    kernels.append(phase_twopass_timing(spec_sweeps, twopass_row, gather22))
    del spec_sweeps, gather22
    report["breadth"] = phase_breadth(dev)
    report["nccl_world1"] = phase_nccl_world1(dev, report["card"])
    torch.cuda.empty_cache()  # the ranks of phase 27 share the card
    report["ranks"] = phase_ranks(report["card"])
    report["dot_order"] = phase_dot_order(dev)
    report["cli"] = phase_cli(dev, img_cli2)
    report["compat_volpath"] = phase_compat_volpath(dev, report["card"])
    report["photon_mapping"] = phase_photon_mapping(dev, report["card"])
    report["bidirectional"] = phase_bidirectional(dev, report["card"])
    report["sparse_regime"] = phase_sparse_regime(dev, kernels)
    report["surface_materials"] = phase_surface_materials(dev, report["card"])
    # each kernel's count from the main-path run that drives it: the
    # config-2 render (forward), the spec step's counted run (backward),
    # the config-3 render (dense hetero forward) and its counted run
    # (sparse hetero forward), the config-3 step (hetero backward)
    counted = {**report["spec_step"]["launches"], **report["main"]["launches"],
               "gather_forward_het":
                   report["smoke"]["launches"]["gather_forward_het"],
               "gather_sparse_het":
                   report["smoke_counted"]["launches"]["gather_sparse_het"],
               "gather_backward_fused_het": report["smoke_steps"]["config3"]
                   ["launches"]["gather_backward_fused_het"],
               "gather_backward_twopass": report["analytic_bwd"]["twopass"]
                   ["launches"]["gather_backward_twopass"]}
    # rows 1 and 3 on the non-packed route: the CLI's config-2 render and
    # phase 23's fused run
    by_route = {"gather_forward": report["cli_config2"]["launches"]
                ["gather_forward"],
                "gather_backward_fused": report["analytic_bwd"]["fused"]
                ["launches"]["gather_backward_fused"]}
    for k in kernels:
        k["launches"] = counted[k["name"]]
        if k["name"] in by_route:
            k["launches_non_packed"] = by_route[k["name"]]
        if k["name"] == "gather_forward":
            k["sweeps"]["CLI config-2 largest sweep (non-packed)"] = route_sweep
        # rows 1 and 5 launched by cli.main: row 1 on config 2 (phase 29
        # (a)), row 5's dense forward on config 3 (phase 29 (b))
        if k["name"] == "gather_forward":
            k["launches_cli"] = report["cli"]["config2"]["launches"][
                "gather_forward"]
        if k["name"] == "gather_forward_het":
            k["launches_cli"] = report["cli"]["config3"]["launches"][
                "gather_forward_het"]
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
        for key in ("err_over_max_ref", "launches_non_packed", "launches_cli",
                    "n_splits", "blocks", "beam_blocks", "regime"):
            if key in kk:
                row[key] = kk[key]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
