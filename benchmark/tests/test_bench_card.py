"""On the H100 only: a short run of each cell at its own sizes through the
command, and the control's reading against the cell's limit."""

import json
import subprocess
import sys

import pytest

from harness import spec

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")
         ["workloads"]]


def _run(args, timeout):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=spec.ROOT, timeout=timeout)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    p = _run([str(spec.BENCH_DIR / "run.py"), "--workload", name, "--seed",
              "4000000007", "--seconds", "1", "--trace", "0"], 600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    p = _run([str(spec.BENCH_DIR / "calibrate.py"), "--workload", name,
              "--seeds", "4000000011", "--controls", "1"], 600)
    assert p.returncode == 0, p.stderr[-3000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    limits = spec.load_json(spec.BENCH_DIR / "workloads" /
                            f"{name}.json")["limits"]
    if "pixel_gap" in limits:  # a render cell: one number
        assert row["program"] <= limits["pixel_gap"] < row["control"]
    else:  # a fit cell: the control fails one of its numbers
        assert all(row["program"][k] <= v for k, v in limits.items())
        assert any(row["control"][k] > v for k, v in limits.items())
