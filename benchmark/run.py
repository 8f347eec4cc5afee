"""The benchmark of ``bre_tpu_torch`` on one NVIDIA H100: one run of one
cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout that holds the program.  With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled part of the
window.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), then ``checked``, each compared number
beside its limit, which also ends standard error.  Without a CUDA card,
or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with 1.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


SETUP_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "bre_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole: ``bre_tpu_torch`` is not ``bre_tpu``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", cell=None) -> dict:
    """One run; returns the result object.  ``cell`` (tests only) replaces
    the cell loaded from ``BENCHMARK.json``."""
    import torch

    from harness import runner, spec

    cell = cell if cell is not None else spec.load_cell(workload)
    e2e, layer, dev, breakdown, checked, attempted, failed = runner.run(
        cell, seed, seconds, trace, device, SETUP_START)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    units.update({m["name"]: m["unit"] for m, _ in cell.per_layer})
    chosen = layer if trace else {k: v for k, v in e2e.items() if k in units}
    metrics = {k: dict(value=float(v), unit=units[k])
               for k, v in chosen.items()}
    if torch.device(device).type == "cuda":
        device_fields = dict(platform="gpu",
                             kind=torch.cuda.get_device_name(0), count=1)
    else:
        device_fields = dict(platform="cpu", kind="cpu", count=0,
                             note="CPU rehearsal: not a device result")
    device_fields.update(dev)
    out = dict(correct=runner.is_correct(checked) and failed == 0,
               attempted=attempted, failed=failed, metrics=metrics,
               device=device_fields)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = checked
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    needs = 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < needs:
        print(f"no CUDA card ({torch.cuda.device_count()} of {needs}): the "
              "benchmark measures the H100 only", file=sys.stderr)
        return 1
    from harness import spec
    cell = spec.load_cell(args.workload)
    needs = int(cell.entry["chips"])
    if torch.cuda.device_count() < needs:
        print(f"the cell needs {needs} cards, {torch.cuda.device_count()} "
              "present", file=sys.stderr)
        return 1
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}; nothing the "
              "benchmark runs may import them", file=sys.stderr)
        return 1
    for name, c in out["checked"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
