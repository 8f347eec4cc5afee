"""The ``fit`` kind: fitting medium parameters to an image with
``optimize_medium`` (Adam through the photon-beam render's gradient).

A mix of this kind (``traffic/<mix>.json``) names the fitted parameters
(``optimize``), ``learning_rate`` and ``tv_weight``, how the seed draws
the true parameters (homogeneous ones: the published value times a factor
uniform in ``true_scale``; the density grid: the published grid times
1 + ``density_perturbation`` * a smooth field of ``density_waves`` random
plane waves, scaled to a largest magnitude of 1), and the target; the
fit starts at the published values, with the density grid at the
published grid's mean.  The target is the mean of
``target_iterations`` iterations of the whole film from the true
parameters, at photon and pixel streams from ``target_first_iteration``
on, at the initial radius.  Every seed has the same sizes and steps.

Set-up renders the target with the program and drives one
``optimize_medium`` call through its first ``setup_steps`` steps: the
first steps build and warm every kernel, and the readings that the check
compares are taken from them.  The same call then runs on as the window,
until ``seconds`` have passed after the set-up's last step; its callback
ends it.  ``fit_s_per_step`` is the window's wall time, read after
``torch.cuda.synchronize()``, over the steps completed in it.

The check, after the window and with the program's state freed: the
reference renders its own target and takes the first ``check.steps``
steps from the same start (``harness/reference.py``); compared are the
targets pixel by pixel, each step's loss, the first gradient's norm per
fitted parameter, and the norm of each parameter's change over those
steps.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from harness import kits, reference, runner
from harness.profiling import FitTracer
from harness.traffic import rng_for


class WindowClosed(Exception):
    """Raised from ``optimize_medium``'s callback to end the window."""


def truth(cell, seed: int) -> dict:
    """The true parameters drawn from the seed, as numpy arrays: a factor
    per homogeneous parameter, and the density grid where it is fitted."""
    mix, med = cell.traffic, cell.config["medium"]
    rng = rng_for(seed, 0)
    out = {}
    for k in sorted(mix["optimize"]):
        if k == "density":
            continue
        out[k] = float(rng.uniform(*mix["true_scale"]))
    if "density" in mix["optimize"]:
        n = med["resolution"]
        z, y, x = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
        field = np.zeros((n, n, n))
        for _ in range(int(mix["density_waves"])):
            k3 = rng.uniform(-np.pi, np.pi, size=3)
            field += np.sin(k3[0] * x + k3[1] * y + k3[2] * z
                            + rng.uniform(0, 2 * np.pi))
        field /= np.abs(field).max()
        grid = cell.recipe.density_grid(n).astype(np.float64)
        out["density"] = (grid * (1.0 + mix["density_perturbation"] * field)
                          ).astype(np.float32)
    return out


def _params(scene, scale: dict, density) -> dict:
    """The medium's parameters on ``scene``'s side: the published ones
    times ``scale``, and ``density`` where given."""
    md = scene.media
    out = dict(sigma_a=md.sigma_a, sigma_s=md.sigma_s, g=md.g,
               density=md.density)
    out = {k: v.detach().clone() * (scale[k] if isinstance(
        scale.get(k), float) else 1.0) for k, v in out.items()}
    if density is not None:
        out["density"] = torch.as_tensor(density, dtype=torch.float32,
                                         device=md.density.device)
    return out


def problem(kit, cell, seed: int, device):
    """(published scene, camera, PhotonBeamConfig, true parameters, start
    parameters) on ``kit``'s side."""
    mix, cfg = cell.traffic, cell.config
    scene = cell.recipe.build_scene(kit, cfg, (1.0, 1.0, 1.0), device)
    camera = kits.make_camera(kit, cfg, 0.0, device)
    pcfg = kits.photonbeam_config(kit, cfg, 1)
    tr = truth(cell, seed)
    true_p = _params(scene, tr, tr.get("density"))
    start_density = None
    if "density" in mix["optimize"]:
        g = cell.recipe.density_grid(cfg["medium"]["resolution"])
        start_density = np.full_like(g, float(g.mean()))
    start_p = _params(scene, {}, start_density)
    return scene, camera, pcfg, true_p, start_p


def _with(scene, params):
    return scene._replace(media=scene.media._replace(**params))


def _target(run, scene, params, mix, radius):
    first, n = int(mix["target_first_iteration"]), int(
        mix["target_iterations"])
    acc = None
    with torch.no_grad():
        for i in range(n):
            Ld = run(first + i, radius, _with(scene, params))
            acc = Ld if acc is None else acc + Ld
    return acc / n


def program_fit(kit, cell, seed: int, device, callback, steps: int):
    """The program's target and one ``optimize_medium`` call of ``steps``
    steps with ``callback``; returns the target (R, 3)."""
    mix, cfg = cell.traffic, cell.config
    W, H = cfg["width"], cfg["height"]
    scene, camera, pcfg, true_p, start_p = problem(kit, cell, seed, device)
    radius = float(np.float32(pcfg.initialbeamradius))
    run = kit.mesh.sharded_photonbeam_iteration(
        scene, camera, W, H, pcfg, None,
        kit.light_power_distribution(_with(scene, true_p)))
    target = _target(run, scene, true_p, mix, radius)
    inv = kit.inverse.InverseConfig(
        steps=steps, learning_rate=mix["learning_rate"],
        optimize=tuple(mix["optimize"]), tv_weight=mix["tv_weight"])
    try:
        kit.inverse.optimize_medium(_with(scene, start_p), camera, W, H,
                                    target, pcfg, inv, init_params=start_p,
                                    callback=callback)
    except WindowClosed:
        pass
    return target


class Readings:
    """What the check compares of the program's first steps: each step's
    loss, the first gradient as the optimizer got it, and the fitted
    parameters after ``n`` steps."""

    def __init__(self, optimize, n: int):
        self.optimize, self.n = tuple(optimize), n
        self.losses, self.grad0, self.after = [], None, None

    def take(self, it: int, loss: float, params: dict) -> None:
        if it < self.n:
            self.losses.append(loss)
        if it == 0:
            self.grad0 = {k: params[k].grad.detach().to("cpu", copy=True)
                          for k in self.optimize}
        if it == self.n - 1:
            self.after = {k: params[k].detach().to("cpu", copy=True)
                          for k in self.optimize}


def run(cell, seed: int, seconds: float, trace: bool, device,
        setup_start: float):
    kit = kits.program_kit()
    mix = cell.traffic
    n_check = int(cell.params["check"]["steps"])
    n_setup = int(cell.params["setup_steps"])
    first = Readings(mix["optimize"], n_check)
    tracer = None
    if trace:
        tracer = FitTracer(kit.mesh, kit.photonbeam,
                           *cell.params["trace"]["steps"])
    st = dict(t0=None, t1=None, steps=0, losses=[], setup_peak=0)

    def callback(it, loss, params):
        first.take(it, loss, params)
        if it == n_setup - 1:
            runner.sync(device)
            st["setup_peak"] = runner.peak(device)
            runner.reset_peak(device)
            if tracer:
                tracer.install()
            st["t0"] = time.perf_counter()
            return
        if st["t0"] is None:
            return
        st["steps"] += 1
        st["losses"].append(loss)
        if tracer:
            tracer.step_done(st["steps"] - 1)
        traced = tracer is None or st["steps"] > tracer.last
        if time.perf_counter() - st["t0"] >= seconds and traced:
            runner.sync(device)
            st["t1"] = time.perf_counter()
            raise WindowClosed

    try:
        target = program_fit(kit, cell, seed, device, callback,
                             int(mix["steps"]))
    finally:
        if tracer:
            tracer.uninstall()
    if st["t1"] is None:
        raise RuntimeError(f"the mix's {mix['steps']} steps ran out before "
                           "the window closed")
    window_s = st["t1"] - st["t0"]
    peak = runner.peak(device)
    e2e = dict(fit_s_per_step=window_s / st["steps"],
               peak_mem_gib=peak / runner.GIB,
               setup_s=st["t0"] - setup_start)
    dev = dict(memory_peak_bytes=max(peak, st["setup_peak"]))
    layer, breakdown = {}, None
    if tracer:
        rd = tracer.readings(cell.config["medium"]["kind"] == "grid",
                             bool(cell.config["grad_extras"]))
        layer, more, breakdown = runner.read_layers(cell, rd)
        dev.update(more)
        tracer.captures.clear()
    target = target.cpu()
    nonfinite = sum(1 for v in st["losses"] if not np.isfinite(v))
    checked = check(cell, seed, target, first, device)
    checked["nonfinite_losses"] = dict(value=nonfinite, limit=0)
    failed = nonfinite + (0 if runner.is_correct(checked) else 1)
    return e2e, layer, dev, breakdown, checked, st["steps"], failed


def reference_fit(cell, seed: int, n_steps: int, device,
                  pair_dtype=torch.float32, times=None):
    """The reference's target and first ``n_steps`` steps, from the seed
    alone: (target on the CPU, losses, first gradient, parameters after
    ``n_steps``, start parameters).  ``times`` (a dict), where given,
    gets the seconds of the target and of the steps."""
    mix, cfg = cell.traffic, cell.config
    kit = kits.reference_kit()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene, camera, pcfg, true_p, start_p = problem(kit, cell, seed, device)
    radius = float(np.float32(pcfg.initialbeamradius))
    token = kit.gather.PAIR_DTYPE.set(pair_dtype)
    t = time.perf_counter()
    try:
        target = _target(reference.film_iteration(
            kit, _with(scene, true_p), camera, cfg["width"], cfg["height"],
            pcfg), scene, true_p, mix, radius)
        runner.sync(device)
        if times is not None:
            times["target_s"] = time.perf_counter() - t
            t = time.perf_counter()
        run = reference.film_iteration(kit, _with(scene, start_p), camera,
                                       cfg["width"], cfg["height"], pcfg)
        losses, grad0, after = reference.fit_steps(
            run, _with(scene, start_p), start_p, target,
            tuple(mix["optimize"]), mix["learning_rate"], mix["tv_weight"],
            n_steps, radius)
        if times is not None:
            times["steps_s"] = time.perf_counter() - t
    finally:
        kit.gather.PAIR_DTYPE.reset(token)
    start = {k: start_p[k].cpu() for k in mix["optimize"]}
    return target.cpu(), losses, grad0, after, start


def compare(cell, ref, target, losses, grad0, after) -> dict:
    """The compared numbers of one side against the reference ``ref``
    (``reference_fit``'s tuple), each with its limit.  A parameter whose
    first gradient in the reference is under a thousandth of the median
    parameter's is left out of the change."""
    t_r, l_r, g_r, a_r, start = ref
    lim = cell.params["limits"]
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in g_r.items()}
    med = float(np.median(list(norms.values())))
    moved = {k for k, n in norms.items() if n >= 1e-3 * med}
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) if np.isfinite(p)
                   else float("inf") for p, r in zip(losses, l_r))
    if len(losses) < len(l_r):
        loss_gap = float("inf")
    out = dict(
        target_gap=reference.pixel_gap([target], [t_r]),
        loss_gap=loss_gap,
        grad_gap=(reference.leaf_gap(grad0, g_r) if grad0 is not None
                  else float("inf")),
        change_gap=(reference.leaf_gap(
            {k: after[k] - start[k] for k in after},
            {k: a_r[k] - start[k] for k in a_r}, keep=moved)
            if after is not None else float("inf")))
    return {k: dict(value=float(v), limit=lim[k]) for k, v in out.items()}


def check(cell, seed, target, first, device) -> dict:
    runner.free(device)
    ref = reference_fit(cell, seed, first.n, device)
    return compare(cell, ref, target, first.losses, first.grad0, first.after)


FAULTS = ("unchanged", "half_batch", "altered")


def planted(kit, fault: str):
    """Patch one fault into the program's timed path; returns the undo.
    ``unchanged``: the optimizer's step leaves the state as it was; ``half_batch``: the step renders and compares only
    the film's first half of rows, the mean taken over them;
    ``altered``: every image is off by 1% where it is produced."""
    inv, mesh = kit.inverse, kit.mesh
    real_step = inv.make_inverse_train_step
    real_pass = mesh.camera_pass_by_pixels
    real_adam = torch.optim.Adam.step
    if fault == "unchanged":
        torch.optim.Adam.step = lambda self, closure=None: None
    elif fault == "half_batch":
        def make(scene, camera, width, height, cfg, mesh_=None):
            return real_step(scene, camera, width, height // 2, cfg, mesh_)
        inv.make_inverse_train_step = make
    elif fault == "altered":
        def altered(*a, **kw):
            Ld, stats = real_pass(*a, **kw)
            return Ld * 1.01, stats
        mesh.camera_pass_by_pixels = altered
    else:
        raise ValueError(fault)

    def undo():
        torch.optim.Adam.step = real_adam
        inv.make_inverse_train_step = real_step
        mesh.camera_pass_by_pixels = real_pass
    return undo


def calibrate(cell, seeds, n_controls: int, device="cuda"):
    """One JSON line per seed: the program's readings against the
    reference's; on the first ``n_controls`` seeds also the bfloat16
    control's and each planted fault's."""
    kit = kits.program_kit()
    n = int(cell.params["check"]["steps"])
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        sides = {"program": None}
        if i < n_controls:
            sides.update({f: f for f in FAULTS})
        got = {}
        for name, fault in sides.items():
            undo = planted(kit, fault) if fault else (lambda: None)
            try:
                first = Readings(cell.traffic["optimize"], n)
                target = program_fit(kit, cell, seed, device, first.take, n)
            finally:
                undo()
            got[name] = (target.cpu(), first.losses, first.grad0,
                         first.after)
            runner.free(device)
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        times = {}
        ref = reference_fit(cell, seed, n, device, times=times)
        t_ref = time.perf_counter() - t
        row = dict(seed=seed, program_s=t_prog, reference_s=t_ref,
                   reference_times=times)
        for name, g in got.items():
            row[name] = {k: c["value"] for k, c in
                         compare(cell, ref, *g).items()}
        if i < n_controls:
            t = time.perf_counter()
            ctl = reference_fit(cell, seed, n, device,
                                pair_dtype=torch.bfloat16)
            row["control_s"] = time.perf_counter() - t
            row["control"] = {k: c["value"] for k, c in compare(
                cell, ref, *ctl[:4]).items()}
        row["reference_losses"] = ref[1]
        print(json.dumps(row), flush=True)
        runner.free(device)
