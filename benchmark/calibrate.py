"""Readings that set the limits of a cell's compared numbers: the
program's, and the lower-precision control's and the planted faults', on
many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 \
        --controls 3

Each seed's readings are taken at the cell's own sizes by the check of the
cell's mix kind (``kinds/<kind>.py``'s ``calibrate``), exactly as a run
takes them; on the first ``--controls`` seeds the control (the reference
with its gather's pair arithmetic in bfloat16) and any fault of that kind
are read too.  One JSON line per seed.  Needs the card; the benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    from harness import spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload)
    cell.kind.calibrate(cell, args.seeds, args.controls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
