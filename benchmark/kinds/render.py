"""The ``render`` kind: back-to-back progressive render jobs of one scene.

A mix of this kind (``traffic/<mix>.json``) gives ``iterations_per_job``
and the number of ``jobs`` drawn; before each job a user retints the light
(a per-channel factor, log-uniform in ``light_scale``) and orbits the
camera about its look-at point (a yaw, uniform in ``orbit_deg``).  Every
job has the same sizes and photon count, so the seed changes what is
rendered, not how much.

Set-up builds nothing the window does not use: the kernel library loads
(or, in a new checkout, builds) at the warm-up job's first gather, and the
warm-up job renders the published scene at the cell's sizes, so every
shape and kernel the window drives has run once.  The window runs the
jobs back to back until ``seconds`` have passed, and ends with the job
that is running then; each job builds its scene and camera and calls
``render_photonbeam``.  The clock is read after ``torch.cuda.synchronize()``.

The check: every window image must be finite, and a sample of the window's
jobs, drawn from the seed, is held to the reference at pixel blocks drawn
from the seed (``harness/reference.py``).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from harness import kits, reference, runner
from harness.profiling import Tracer
from harness.traffic import rng_for


@dataclasses.dataclass(frozen=True)
class RenderJob:
    light_scale: tuple  # per-channel factor on the published emission
    orbit_deg: float  # yaw of the eye about the look-at point
    iterations: int


def published_job(mix: dict) -> RenderJob:
    """The scene as published: the set-up's warm-up job."""
    return RenderJob((1.0, 1.0, 1.0), 0.0, int(mix["iterations_per_job"]))


def jobs(mix: dict, seed: int) -> list:
    rng = rng_for(seed, 0)
    lo, hi = np.log(mix["light_scale"][0]), np.log(mix["light_scale"][1])
    scales = np.exp(rng.uniform(lo, hi, size=(mix["jobs"], 3)))
    orbits = rng.uniform(*mix["orbit_deg"], size=mix["jobs"])
    n = int(mix["iterations_per_job"])
    return [RenderJob(tuple(float(v) for v in s), float(o), n)
            for s, o in zip(scales, orbits)]


def render_job(kit, cell, job, device):
    scene, camera, pcfg = kits.build(kit, cell, job, device)
    image, _ = kit.photonbeam.render_photonbeam(
        scene, camera, cell.config["width"], cell.config["height"], pcfg)
    return image


def run(cell, seed: int, seconds: float, trace: bool, device,
        setup_start: float):
    kit = kits.program_kit()
    todo = jobs(cell.traffic, seed)
    with torch.no_grad():
        render_job(kit, cell, published_job(cell.traffic), device)
    runner.sync(device)
    setup_peak = runner.peak(device)
    tracer = None
    if trace:
        tr = cell.params["trace"]
        tracer = Tracer(kit.photonbeam, tr["job"], *tr["iterations"])
        tracer.install()
    runner.reset_peak(device)
    images, iters = [], 0
    t0 = time.perf_counter()
    setup_s = t0 - setup_start
    try:
        with torch.no_grad():
            for k, job in enumerate(todo):
                if tracer:
                    tracer.job_start(k)
                images.append(render_job(kit, cell, job, device))
                if tracer:
                    tracer.job_done()
                iters += job.iterations
                runner.sync(device)
                if time.perf_counter() - t0 >= seconds:
                    break
            else:
                raise RuntimeError(f"the mix's {len(todo)} jobs ran out "
                                   "before the window closed")
        window_s = time.perf_counter() - t0
    finally:
        if tracer:
            tracer.uninstall()
    peak = runner.peak(device)
    e2e = dict(render_s_per_iter=window_s / iters,
               peak_mem_gib=peak / runner.GIB, setup_s=setup_s)
    dev = dict(memory_peak_bytes=max(peak, setup_peak))
    layer, breakdown = {}, None
    if tracer:
        rd = tracer.readings(cell.config["medium"]["kind"] == "grid")
        layer, more, breakdown = runner.read_layers(cell, rd)
        dev.update(more)
        tracer.captures.clear()
    checked, attempted, failed = check(cell, seed, todo, images, device)
    return e2e, layer, dev, breakdown, checked, attempted, failed


def check(cell, seed, todo, images, device, controls=()):
    """Every window image must be finite; a sample of the window's jobs,
    drawn from the seed, is held to the reference at a sample of pixel
    blocks.  The program's state is freed before the reference runs.
    Each dtype of ``controls`` also runs the reference in its place with
    the gather's pair arithmetic in that dtype (``calibrate``); their
    gaps come back under ``control_gaps``."""
    chk = cell.params["check"]
    rng = rng_for(seed, 1)
    n = len(images)
    picked = sorted(rng.choice(n, size=min(chk["jobs"], n), replace=False))
    W, H = cell.config["width"], cell.config["height"]
    finite = [bool(torch.isfinite(im).all()) for im in images]
    blocks, programs = {}, {}
    for j in picked:
        blocks[j] = reference.pixel_blocks(rng, W, H, chk["blocks"],
                                           chk["block"])
        flat = images[j].reshape(-1, 3)
        programs[j] = [flat[torch.as_tensor(b, device=flat.device)].cpu()
                       for b in blocks[j]]
    images.clear()
    runner.free(device)
    ref_kit = kits.reference_kit()
    gaps, control_gaps = [], {str(dt): [] for dt in controls}
    for j in picked:
        ref = reference.render_pixels(ref_kit, cell, todo[j], blocks[j],
                                      device)
        gaps.append(reference.pixel_gap(programs[j], ref))
        for dt in controls:
            ctl = reference.render_pixels(ref_kit, cell, todo[j], blocks[j],
                                          device, pair_dtype=dt)
            control_gaps[str(dt)].append(reference.pixel_gap(ctl, ref))
    limit = cell.params["limits"]["pixel_gap"]
    gap = max(gaps)
    failed = sum(1 for f in finite if not f) + sum(
        1 for g in gaps if not g <= limit)
    checked = dict(pixel_gap=dict(value=gap, limit=limit),
                   nonfinite_images=dict(value=finite.count(False), limit=0))
    if controls:
        checked["control_gaps"] = {k: max(v) for k, v in control_gaps.items()}
    return checked, n, failed


def calibrate(cell, seeds, n_controls: int, device="cuda"):
    """One JSON line per seed: the program's reading on the mix's first
    job, and on the first ``n_controls`` seeds the bfloat16 control's."""
    kit = kits.program_kit()
    with torch.no_grad():
        render_job(kit, cell, published_job(cell.traffic), device)
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        todo = jobs(cell.traffic, seed)
        with torch.no_grad():
            image = render_job(kit, cell, todo[0], device)
        ctl = (torch.bfloat16,) if i < n_controls else ()
        checked, _, failed = check(cell, seed, todo, [image], device,
                                   controls=ctl)
        print(json.dumps(dict(
            seed=seed, program=checked["pixel_gap"]["value"],
            control=checked.get("control_gaps", {}).get("torch.bfloat16"),
            failed=failed, seconds=time.perf_counter() - t)), flush=True)
