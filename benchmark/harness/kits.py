"""The two sides a run builds scenes for: the program (``bre_tpu_torch``)
and the reference (``pbref``, the frozen plain copy).  Both have the same
API, so one recipe and one job description serve both; each side builds
its own scene, camera and configuration from them.

``program_kit`` imports the program only when it is called, so a process
that runs only the reference never loads it.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

from .traffic import orbit_eye


def program_kit() -> SimpleNamespace:
    from bre_tpu_torch.core import transform
    from bre_tpu_torch.integrators import inverse, photonbeam
    from bre_tpu_torch.lights import light_power_distribution
    from bre_tpu_torch.parallel import mesh
    from bre_tpu_torch.scene.builder import SceneBuilder
    from bre_tpu_torch.scene.camera import make_perspective_camera
    return SimpleNamespace(name="program", photonbeam=photonbeam,
                           SceneBuilder=SceneBuilder,
                           make_perspective_camera=make_perspective_camera,
                           look_at=transform.look_at, inverse=inverse,
                           mesh=mesh,
                           light_power_distribution=light_power_distribution)


def reference_kit() -> SimpleNamespace:
    from pbref.core import transform
    from pbref.integrators import common, photon_trace, photonbeam
    from pbref.lights import light_power_distribution
    from pbref.ops import gather
    from pbref.scene.builder import SceneBuilder
    from pbref.scene.camera import make_perspective_camera, pixel_centers
    return SimpleNamespace(name="reference", photonbeam=photonbeam,
                           SceneBuilder=SceneBuilder,
                           make_perspective_camera=make_perspective_camera,
                           look_at=transform.look_at, common=common,
                           photon_trace=photon_trace, gather=gather,
                           light_power_distribution=light_power_distribution,
                           pixel_centers=pixel_centers)


def make_camera(kit, cfg: dict, orbit_deg: float, device):
    cam = cfg["camera"]
    eye = orbit_eye(cam["eye"], cam["look"], cam["up"], orbit_deg)
    return kit.make_perspective_camera(
        kit.look_at(eye, tuple(cam["look"]), tuple(cam["up"])),
        cam["fov_deg"], cfg["width"], cfg["height"], device=device)


def photonbeam_config(kit, cfg: dict, iterations: int):
    """The configuration's ``PhotonBeamConfig``; everything else keeps the
    port's defaults (``imagewritefrequency`` among them: no host copy of
    the image between iterations)."""
    keys = ("maxdepth", "photonsperiteration", "initialbeamradius", "alpha",
            "gather", "gather_chunk", "grad_geometry", "grad_extras")
    pbc = kit.photonbeam.PhotonBeamConfig
    names = {f.name for f in dataclasses.fields(pbc)}
    return pbc(iterations=iterations,
               **{k: cfg[k] for k in keys if k in names})


def build(kit, cell, job, device):
    """(scene, camera, PhotonBeamConfig) of one job on ``kit``'s side."""
    scene = cell.recipe.build_scene(kit, cell.config, job.light_scale,
                                    device)
    camera = make_camera(kit, cell.config, job.orbit_deg, device)
    return scene, camera, photonbeam_config(kit, cell.config, job.iterations)
