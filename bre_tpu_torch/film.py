"""Film with reconstruction filters, the same film as ``bre_tpu/film.py``.

pbrt's film (film.{h,cpp}): ``AddSample`` weighted accumulation (film.h:121),
``SetImage``, the direct-assign path of the SPPM-family integrators
(film.cpp:~155); the filters of src/filters/ (box, triangle, gaussian,
mitchell, sinc).

The film is a pair of accumulators ``(weighted (H, W, 3), weight (H, W))``.
``add_samples`` splats each sample into the static footprint around it, one
footprint offset at a time; each offset's splat is one
``core.math.ordered_index_sum`` over the flattened pixel ids, so two runs on
a card give the same bits (``index_put_(accumulate=True)`` adds in an
unfixed order there).  The sum order is not XLA's, so the image matches the
reference's to rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .core.math import ordered_index_sum
from .scene.scene import resolve_device

FILTER_BOX = "box"
FILTER_TRIANGLE = "triangle"
FILTER_GAUSSIAN = "gaussian"
FILTER_MITCHELL = "mitchell"
FILTER_SINC = "sinc"


def filter_eval(name: str, x: np.ndarray, radius: float = 2.0,
                alpha: float = 2.0, B: float = 1.0 / 3.0, C: float = 1.0 / 3.0,
                tau: float = 3.0) -> np.ndarray:
    """1D filter kernels (src/filters/*.cpp Evaluate methods), on the host:
    the reference evaluates them with numpy for its filter table."""
    ax = np.abs(x)
    if name == FILTER_BOX:
        return (ax <= radius).astype(np.float32)
    if name == FILTER_TRIANGLE:
        return np.maximum(0.0, radius - ax).astype(np.float32)
    if name == FILTER_GAUSSIAN:
        e = np.exp(-alpha * x * x) - np.exp(-alpha * radius * radius)
        return np.maximum(0.0, e).astype(np.float32)
    if name == FILTER_MITCHELL:
        x2 = ax * 2.0 / radius
        m = np.where(
            x2 > 1,
            ((-B - 6 * C) * x2**3 + (6 * B + 30 * C) * x2**2
             + (-12 * B - 48 * C) * x2 + (8 * B + 24 * C)) * (1.0 / 6.0),
            ((12 - 9 * B - 6 * C) * x2**3 + (-18 + 12 * B + 6 * C) * x2**2
             + (6 - 2 * B)) * (1.0 / 6.0),
        )
        return np.where(x2 <= 2, m, 0.0).astype(np.float32)
    if name == FILTER_SINC:  # windowed (Lanczos)
        def sinc(v):
            v = np.abs(v)
            return np.where(v < 1e-5, 1.0, np.sin(np.pi * v) / (np.pi * v))
        return np.where(ax <= radius, sinc(x) * sinc(x / tau),
                        0.0).astype(np.float32)
    raise ValueError(f"unknown filter '{name}'")


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    name: str = FILTER_BOX
    xwidth: float = 0.5
    ywidth: float = 0.5


class Film(NamedTuple):
    """The two accumulators (pbrt's Film + FilmTile)."""

    weighted: torch.Tensor  # (H, W, 3)
    weight: torch.Tensor  # (H, W)

    @property
    def image(self) -> torch.Tensor:
        w = torch.clamp_min(self.weight, 1e-12)[..., None]
        return self.weighted / w


def make_film(width: int, height: int, device="cuda") -> Film:
    dev = resolve_device(device)
    return Film(weighted=torch.zeros((height, width, 3), device=dev),
                weight=torch.zeros((height, width), device=dev))


def add_samples(film: Film, p_raster: torch.Tensor, L: torch.Tensor,
                spec: FilterSpec = FilterSpec()) -> Film:
    """Splat samples into their filter footprints (Film::AddSample,
    film.h:121): each pixel within the filter radius of a sample at raster
    position p receives ``f(p - pixel_center) * L`` and weight
    ``f(p - pixel_center)``.  The footprint is the static square of
    2 ceil(width - 0.5) + 2 pixels a side around the sample."""
    H, W = film.weight.shape
    fx = int(np.ceil(spec.xwidth - 0.5)) + 1
    fy = int(np.ceil(spec.ywidth - 0.5)) + 1
    px = p_raster[:, 0]
    py = p_raster[:, 1]
    ix0 = torch.floor(px - 0.5).to(torch.int64)
    iy0 = torch.floor(py - 0.5).to(torch.int64)
    weighted, weight = film.weighted, film.weight
    for oy in range(-fy + 1, fy + 1):
        for ox in range(-fx + 1, fx + 1):
            X = ix0 + ox
            Y = iy0 + oy
            dx = (X.to(torch.float32) + 0.5) - px
            dy = (Y.to(torch.float32) + 0.5) - py
            w = _filter_eval_torch(spec, dx) * _filter_eval_torch(spec, dy)
            ok = (X >= 0) & (X < W) & (Y >= 0) & (Y < H) & (w > 0.0)
            ids = Y.clamp(0, H - 1) * W + X.clamp(0, W - 1)
            wm = torch.where(ok, w, 0.0)[:, None]
            # the image and the weight in one sorted pass: four columns
            acc = ordered_index_sum(ids, torch.cat([wm * L, wm], 1), H * W)
            weighted = weighted + acc[:, :3].reshape(H, W, 3)
            weight = weight + acc[:, 3].reshape(H, W)
    return Film(weighted=weighted, weight=weight)


def set_image(film: Film, image: torch.Tensor) -> Film:
    """Film::SetImage (film.cpp:~155): the SPPM-family direct-assign path."""
    H, W = film.weight.shape
    return Film(weighted=image.reshape(H, W, 3),
                weight=torch.ones((H, W), device=image.device))


def _filter_eval_torch(spec: FilterSpec, x: torch.Tensor) -> torch.Tensor:
    """The filters on float32 tensors, as the reference's _filter_eval_jnp
    (every constant rounded to float32 where it meets a tensor)."""
    r = spec.xwidth
    ax = torch.abs(x)
    if spec.name == FILTER_BOX:
        return (ax <= r).to(torch.float32)
    if spec.name == FILTER_TRIANGLE:
        return torch.clamp_min(r - ax, 0.0)
    if spec.name == FILTER_GAUSSIAN:
        alpha = 2.0
        # the float64 constant, rounded to float32 where it meets x
        return torch.clamp_min(torch.exp(-alpha * x * x)
                               - float(np.exp(-alpha * r * r)), 0.0)
    if spec.name == FILTER_MITCHELL:
        B = C = 1.0 / 3.0
        x2 = ax * 2.0 / r
        sq = x2 * x2
        cube = sq * x2
        m = torch.where(
            x2 > 1,
            ((-B - 6 * C) * cube + (6 * B + 30 * C) * sq
             + (-12 * B - 48 * C) * x2 + (8 * B + 24 * C)) * (1.0 / 6.0),
            ((12 - 9 * B - 6 * C) * cube + (-18 + 12 * B + 6 * C) * sq
             + (6 - 2 * B)) * (1.0 / 6.0),
        )
        return torch.where(x2 <= 2, m, 0.0)
    if spec.name == FILTER_SINC:
        tau = 3.0

        def sinc(v):
            v = torch.abs(v)
            return torch.where(v < 1e-5, 1.0,
                               torch.sin(math.pi * v) / (math.pi * v))
        return torch.where(ax <= r, sinc(x) * sinc(x / tau), 0.0)
    raise ValueError(spec.name)
