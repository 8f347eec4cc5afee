"""Sampler streams (counterpart of ``bre_tpu/core/samplers.py``).

Only the ``"random"`` sampler is ported (samplers.py:255-420 for that
kind): every dimension is the next ``UniformFloat`` of the lane's PCG32
stream, so its sample stream is the bare PCG32 state, which is also what
the photon-beam path draws from.  The low-discrepancy kinds (``halton``,
``sobol``, ``stratified``, ``02sequence``, ``maxmindist``) raise
NotImplementedError (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .rng import PCG32State, pcg32_next_f32


class StreamSpec(NamedTuple):
    """Static sampler parameters (the ``"random"`` kind needs none beyond
    its name and the sample count)."""

    kind: str
    spp: int


def make_stream_spec(kind: str, width: int, height: int, spp: int) -> StreamSpec:
    """The sampler's static parameters (samplers.py:255-276)."""
    if kind != "random":
        raise NotImplementedError(
            f'sampler "{kind}" is not ported; only "random" is (ROADMAP '
            "Queue 1 item 5: breadth, core/samplers)")
    return StreamSpec(kind, int(spp))


def make_sample_stream(spec: StreamSpec, pixel_idx, px, py, sample_idx,
                       rng: PCG32State) -> PCG32State:
    """The per-pass stream of ``rng``'s lanes (samplers.py:311-346): for
    ``"random"``, ``rng`` itself; the pixel and sample indices select
    nothing."""
    return rng


def stream_1d(s: PCG32State):
    """Generic Get1D: one ``UniformFloat`` draw."""
    return pcg32_next_f32(s)


def stream_2d(s: PCG32State):
    """Generic Get2D: two 1D draws, (first, second)."""
    s, a = stream_1d(s)
    s, b = stream_1d(s)
    return s, torch.stack([a, b], -1)


def stream_rng(s: PCG32State) -> PCG32State:
    """The raw PCG32 streams under a sampler stream: a bare state is its
    own (inner tracking loops draw from it without consuming dimensions)."""
    return s


def stream_with_rng(s: PCG32State, rng: PCG32State) -> PCG32State:
    """The sampler stream ``s`` with its raw streams replaced by ``rng``;
    for a bare state, ``rng`` itself."""
    return rng


def stream_camera_sample(s: PCG32State):
    """Dims 0-4 in GetCameraSample's order (sampler.cpp): film offset (2),
    time (1), lens (2).  Returns (stream, film (R,2), time (R,), lens
    (R,2)); called first."""
    s, film = stream_2d(s)
    s, time = stream_1d(s)
    s, lens = stream_2d(s)
    return s, film, time, lens
