"""bre_tpu_torch — the PyTorch / CUDA port of ``bre_tpu``.

The JAX package ``bre_tpu`` is the reference; this package mirrors its module
layout (``core/``, ``scene/``, ``integrators/``, ``accel/``, ``ops/``,
``parallel/``) so each function has a counterpart of the same name.  Tensors
are float32 with explicit integer dtypes; the device follows the scene's
tensors, and the entry points that make them build on "cuda" unless the
caller asks for the CPU.

The ported slices: the forward progressive photon-beam render
(``integrators.photonbeam.render_photonbeam``) on homogeneous and
grid-density media, and its gradient in the medium parameters and the
density grid (``parallel.mesh.make_inverse_train_step``,
``integrators.inverse.optimize_medium``), on one device or sharded over
the ranks of a ``torch.distributed`` process group (``parallel.mesh``,
``parallel.dryrun``), with the beam-radiance gather and its backward on
hand-written CUDA kernels (``ops/gather.py``, ``ops/gather_bwd.py``,
``csrc/``), and the scene input around them: the ``.pbrt`` parser, image
and PLY I/O, checkpoint/resume and the command line,
``python -m bre_tpu_torch.cli scene.pbrt``; the reference's other
integrators, and every material, texture, light, shape and camera its
parser builds; and the modules around them: the film's reconstruction
filters (``film``), statistics and profiler traces (``utils.stats``),
EFloat (``core.efloat``) and the command-line tools (``tools``).
"""

from .integrators.photonbeam import PhotonBeamConfig, render_photonbeam
from .scene.builder import SceneBuilder
from .scene.camera import make_perspective_camera

__all__ = ["PhotonBeamConfig", "SceneBuilder", "make_perspective_camera",
           "render_photonbeam"]
