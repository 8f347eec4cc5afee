"""Sampler streams (counterpart of ``bre_tpu/core/samplers.py``).

The slice draws every sample from bare PCG32 streams, so only the forms for
a ``PCG32State`` are ported (``stream_1d``, and ``stream_rng`` /
``stream_with_rng`` for the grid tracking loop); the low-discrepancy
``SampleStream`` kinds are ROADMAP Queue 1 "breadth".
"""

from __future__ import annotations

from .rng import PCG32State, pcg32_next_f32


def stream_1d(s: PCG32State):
    """Generic Get1D on a bare PCG32 state: one ``UniformFloat`` draw."""
    return pcg32_next_f32(s)


def stream_rng(s: PCG32State) -> PCG32State:
    """The raw PCG32 streams under a sampler stream: a bare state is its
    own (inner tracking loops draw from it without consuming dimensions)."""
    return s


def stream_with_rng(s: PCG32State, rng: PCG32State) -> PCG32State:
    """The sampler stream ``s`` with its raw streams replaced by ``rng``;
    for a bare state, ``rng`` itself."""
    return rng
