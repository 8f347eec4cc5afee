"""What every kind of run shares: the card's clock and memory, the
per-layer readings of a traced run, and the verdict on the compared
numbers.  Each mix kind's set-up, window and check are in
``kinds/<kind>.py``, found by the mix's ``kind``."""

from __future__ import annotations

import gc
import math

import torch

GIB = float(1 << 30)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def free(device) -> None:
    """Return what the program held to the card before the reference
    runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def read_layers(cell, rd) -> tuple:
    """(per-layer metrics, device fields, breakdown) of a traced run's
    readings; a reader that finds nothing is left out."""
    layer = {}
    for entry, mod in cell.per_layer:
        v = mod.read(rd)
        if v is not None:
            layer[entry["name"]] = v
    return layer, dict(busy_s=rd.busy_s, window_s=rd.window_s), \
        rd.breakdown()


def is_correct(checked: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())


def run(cell, seed: int, seconds: float, trace: bool, device,
        setup_start: float):
    """The cell's run, by its mix's kind.  Returns (end-to-end metrics,
    per-layer metrics, device fields, breakdown, checked numbers,
    attempted, failed)."""
    return cell.kind.run(cell, seed, seconds, trace, device, setup_start)
