"""The 60-bin spectral render mode by band slicing (counterpart of
``bre_tpu/integrators/spectral.py``; pbrt's PBRT_SAMPLED_SPECTRUM build,
pbrt.h:110-111).

The 60 bins render as 20 slices of 3 bins through the RGB volpath: in
slice k every color of the scene is its lifted SPD at the slice's three
bin wavelengths, so each slice render is an exact 3-bin transport solve.
The 20 slice images are the spectral image; it integrates to XYZ against
the CIE matching functions (``sampled_spectrum.to_xyz``) and to RGB, white
balanced to illuminant E.  RGB inputs lift with a map whose achromatic
axis is flat (gray stays gray through the transport) and whose chromatic
part is the smoothest metamer.  The slices share the sampler streams, as
one path carries all bins in pbrt's 60-bin build.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import sampled_spectrum as ss
from ..core.spectrum import _XYZ_TO_RGB, xyz_to_rgb
from ..scene.camera import Camera
from ..scene.scene import Scene
from .volpath import VolPathConfig, render_volpath

N_SLICES = ss.N_SAMPLES // 3  # 20


def _achromatic_preserving_lift() -> np.ndarray:
    """(60, 3) linear lift: rgb -> mean(rgb) * flat + smoothest-metamer(rgb
    - mean(rgb)) (spectral.py:59-69), float64."""
    n = ss.N_SAMPLES
    ones3 = np.full((3, 3), 1.0 / 3.0)
    flat = np.ones((n, 1)) @ np.ones((1, 3)) / 3.0
    return flat + ss._RGB_TO_SPECTRUM @ (np.eye(3) - ones3)


_LIFT = _achromatic_preserving_lift()
# white balance to illuminant E: a flat unit SPD integrates back to RGB 1
_FLAT_XYZ = (ss._CMF * ss._DLAM).sum(0) / ss.CIE_Y_INTEGRAL
_WB = 1.0 / np.maximum(np.asarray(_XYZ_TO_RGB) @ _FLAT_XYZ, 1e-6)


def _slice_lift_matrix(k: int, device="cpu") -> torch.Tensor:
    """(3, 3): an RGB triple -> its lifted SPD at slice k's three bins."""
    return torch.as_tensor(_LIFT[3 * k:3 * k + 3, :], dtype=torch.float32,
                           device=device)


def slice_scene(scene: Scene, k: int) -> Scene:
    """The scene with every color field lifted to slice k's wavelengths
    (spectral.py:91-115): the materials' kd and ks, and their mix amounts
    clipped to [0, 1], the lights' emission, the media's sigma_a and
    sigma_s (the reference's other lifted fields, the BSSRDF coefficients
    and light images, belong to materials and lights the port does not
    carry; conductor eta/k and textures stay RGB, as there)."""
    L = _slice_lift_matrix(k, scene.device)

    def lift(c):
        return torch.clamp_min(c @ L.T, 0.0)

    m = scene.materials
    return scene._replace(
        materials=m._replace(kd=lift(m.kd), ks=lift(m.ks),
                             mix_amount=torch.clamp(lift(m.mix_amount),
                                                    0.0, 1.0)),
        lights=scene.lights._replace(emit=lift(scene.lights.emit)),
        media=scene.media._replace(sigma_a=lift(scene.media.sigma_a),
                                   sigma_s=lift(scene.media.sigma_s)))


def render_volpath_spectral(scene: Scene, camera: Camera, width: int,
                            height: int, cfg: VolPathConfig = VolPathConfig(),
                            return_spectrum: bool = False):
    """Spectral volpath (spectral.py:118-140): the 20 slices rendered and
    integrated to RGB.  Returns the (H, W, 3) image, and with
    ``return_spectrum`` also the (H, W, 60) spectral image."""
    spec = torch.cat([render_volpath(slice_scene(scene, k), camera, width,
                                     height, cfg)
                      for k in range(N_SLICES)], -1)
    rgb = xyz_to_rgb(ss.to_xyz(spec)) * torch.as_tensor(
        _WB, dtype=torch.float32, device=spec.device)
    if return_spectrum:
        return rgb, spec
    return rgb
