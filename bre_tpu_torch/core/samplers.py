"""Sampler streams (counterpart of ``bre_tpu/core/samplers.py``).

The slice draws every sample from bare PCG32 streams, so only the
``stream_1d`` form for a ``PCG32State`` is ported; the low-discrepancy
``SampleStream`` kinds are ROADMAP Queue 1 "breadth".
"""

from __future__ import annotations

from .rng import PCG32State, pcg32_next_f32


def stream_1d(s: PCG32State):
    """Generic Get1D on a bare PCG32 state: one ``UniformFloat`` draw."""
    return pcg32_next_f32(s)
