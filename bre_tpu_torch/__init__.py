"""bre_tpu_torch — the PyTorch / CUDA port of ``bre_tpu``.

The JAX package ``bre_tpu`` is the reference; this package mirrors its module
layout (``core/``, ``scene/``, ``integrators/``, ``accel/``, ``ops/``) so each
function has a counterpart of the same name.  Tensors are float32 with
explicit integer dtypes; the device follows the scene's tensors.

The ported slice is the forward progressive photon-beam render
(``integrators.photonbeam.render_photonbeam``) on homogeneous media, with the
packed beam-radiance gather running on hand-written CUDA kernels
(``ops/gather.py``, ``csrc/beam_gather_fwd.cu``).  Paths outside the slice
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from .integrators.photonbeam import PhotonBeamConfig, render_photonbeam
from .scene.builder import SceneBuilder
from .scene.camera import make_perspective_camera

__all__ = ["PhotonBeamConfig", "SceneBuilder", "make_perspective_camera",
           "render_photonbeam"]
