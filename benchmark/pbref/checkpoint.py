"""Checkpoint and resume of the progressive render (counterpart of
``bre_tpu/checkpoint.py``).

pbrt's photon-beam integrator resumes an iteration range through
``startiteration``/``enditeration``, with the radius schedule fast-forwarded
(photonbeam.cpp:354-357, 594-595), and writes the film every
``imagewritefrequency`` iterations (:565-584).  A checkpoint makes that
state explicit: (iteration, radius, buffers), in the reference's ``.npz``
layout (a ``__meta__`` JSON string and one array per buffer, ``Ld`` for the
photon-beam render), so a checkpoint written by either package loads in the
other.  Host-side numpy: callers copy device buffers to the host first.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np


def save_checkpoint(path, iteration: int, radius: float, buffers: dict) -> None:
    """Save progressive state; ``buffers`` maps names to arrays.  Written
    atomically (a temporary file, then a rename)."""
    path = Path(path)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(
        tmp,
        __meta__=json.dumps({"iteration": iteration, "radius": radius}),
        **{k: np.asarray(v) for k, v in buffers.items()},
    )
    tmp.rename(path)


def load_checkpoint(path) -> Optional[dict]:
    """Returns {"iteration", "radius", "buffers"}, or None if absent."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        buffers = {k: data[k] for k in data.files if k != "__meta__"}
    return {"iteration": meta["iteration"], "radius": meta["radius"],
            "buffers": buffers}
