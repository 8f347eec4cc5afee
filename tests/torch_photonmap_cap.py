"""Why photonmap reads below volpath on the fog cube: the share of the
volume photons' power that the per-cell slot cap K leaves unread, and the
ratio of the image's mean to volpath's at several K.  Not a test.

    python3 tests/torch_photonmap_cap.py              # the port, on the card
    python3 tests/torch_photonmap_cap.py --device cpu
    python3 tests/torch_photonmap_cap.py --reference  # bre_tpu, JAX on the CPU

The scene and sizes are chip_smoke.py phase 31 (e)'s: tests/test_photonmap.py's
fog cube (no surfaces; a point light at the centre of a [-1, 1]^3 medium),
64x64, PhotonMapConfig()'s defaults (50,000 photons, 4 spp, 32 march steps,
K = 64) and volpath at 64 spp.  ``--reference`` renders bre_tpu's
photonmap and volpath at K = 64 only.  Prints one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W = 64
LOOK = ((0, 0, -3.5), (0, 0, 0), (0, 1, 0))
CAPS = (64, 256, 1024)


def unread_share(pclass, valid, keys, power, K):
    """Luminance share of the valid volume photons past slot K of their
    cell (the gathers read slots [0, K) of a cell's run of sorted keys)."""
    pclass, valid, keys, power = (np.asarray(a) for a in
                                  (pclass, valid, keys, power))
    vol = valid & (pclass == 3)
    first = np.searchsorted(keys, keys, side="left")
    slot = np.arange(keys.shape[0]) - first
    lum = power @ np.array([0.212671, 0.715160, 0.072169], np.float64)
    return float(lum[vol & (slot >= K)].sum() / lum[vol].sum())


def run_port(device):
    import torch

    from bre_tpu_torch.core import transform as tfm
    from bre_tpu_torch.integrators.photonmap import (PhotonMapConfig,
                                                     render_photonmap,
                                                     shoot_photons)
    from bre_tpu_torch.integrators.volpath import VolPathConfig, render_volpath
    from bre_tpu_torch.scene.builder import SceneBuilder
    from bre_tpu_torch.scene.camera import make_perspective_camera

    dev = torch.device(device)
    b = SceneBuilder()
    fog = b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.0)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.point_light((0.0, 0.0, 0.0), (1.0,) * 3, medium=fog)
    cube = b.build(device=dev)
    cam = make_perspective_camera(tfm.look_at(*LOOK), 40.0, W, W, device=dev)
    truth = float(render_volpath(cube, cam, W, W,
                                 VolPathConfig(spp=64)).mean())
    maps = shoot_photons(cube, PhotonMapConfig())
    out = dict(device=device, volpath_mean=truth, rows=[])
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for K in CAPS:
        cfg = PhotonMapConfig(max_photons_per_cell=K)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, st = render_photonmap(cube, cam, W, W, cfg)
        mean = float(img.mean())
        s = time.perf_counter() - t0
        out["rows"].append(dict(
            K=K, unread=unread_share(maps.pclass.cpu(), maps.valid.cpu(),
                                     maps.keys.cpu(), maps.power.cpu().double(),
                                     K),
            mean=mean, ratio=mean / truth, s=s,
            volume_photons=st["photon_counts"]["volume"]))
    return out


def run_reference():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bre_tpu.core import transform as tfm
    from bre_tpu.integrators.photonmap import (PhotonMapConfig,
                                               render_photonmap,
                                               shoot_photons)
    from bre_tpu.integrators.volpath import VolPathConfig, render_volpath
    from bre_tpu.scene.builder import SceneBuilder
    from bre_tpu.scene.camera import make_perspective_camera

    b = SceneBuilder()
    fog = b.homogeneous_medium((0.05,) * 3, (0.4,) * 3, 0.0)
    b.box((-1, -1, -1), (1, 1, 1), material=-1, medium_inside=fog,
          medium_outside=-1)
    b.point_light((0.0, 0.0, 0.0), (1.0,) * 3, medium=fog)
    cube = b.build()
    cam = make_perspective_camera(tfm.look_at(*LOOK), 40.0, W, W)
    truth = float(np.asarray(render_volpath(cube, cam, W, W,
                                            VolPathConfig(spp=64))).mean())
    cfg = PhotonMapConfig()
    maps = shoot_photons(cube, cfg)
    t0 = time.perf_counter()
    img, st = render_photonmap(cube, cam, W, W, cfg)
    mean = float(np.asarray(img).mean())
    return dict(device="cpu (bre_tpu)", volpath_mean=truth, rows=[dict(
        K=cfg.max_photons_per_cell,
        unread=unread_share(maps.pclass, maps.valid, maps.keys,
                            np.asarray(maps.power, np.float64),
                            cfg.max_photons_per_cell),
        mean=mean, ratio=mean / truth, s=time.perf_counter() - t0,
        volume_photons=st["photon_counts"]["volume"])])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", action="store_true",
                    help="bre_tpu's render on the CPU instead of the port's")
    a = ap.parse_args()
    print(json.dumps(run_reference() if a.reference else run_port(a.device)))


if __name__ == "__main__":
    main()
