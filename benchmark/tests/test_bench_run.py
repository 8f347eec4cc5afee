"""CPU runs of the harness at a tiny size: down to the result line, with
the end-to-end numbers taken over all the window's work and time, the
check failing on a broken timed path, and the lower-precision control
failing the check.  None of these is a device result."""

import json
import subprocess
import sys
import time

import pytest
import torch

import run as bench_run
from harness import kits, spec
from tiny import tiny_cell

WORKLOADS = spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
RENDER = [w["name"] for w in WORKLOADS if w["traffic"] == "render"]
FIT = [w["name"] for w in WORKLOADS if w["traffic"] == "fit"]
SEED = 3_000_000_019  # over 2**31, as the driver's are


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cpu_run_to_the_last_line(name, capsys):
    out = bench_run.run(name, SEED, 0.2, False, device="cpu",
                        cell=tiny_cell(name))
    assert out["device"]["platform"] == "cpu"
    assert "not a device result" in out["device"]["note"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert list(out)[-1] == "checked"
    cell = spec.load_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
    json.loads(json.dumps(out))


def test_tiny_cpu_traced_run():
    name = RENDER[0]
    cell = tiny_cell(name, iterations=4)
    out = bench_run.run(name, SEED, 0.2, True, device="cpu", cell=cell)
    assert out["correct"] is True
    assert out["device"]["window_s"] > 0
    assert "breakdown" in out
    # the CPU trace has no device operation: the kernel metrics are absent
    assert "fwd_gather_ms.render" not in out["metrics"]
    assert out["metrics"]["trace_ms.render"]["value"] > 0
    assert out["metrics"]["camera_pass_ms.render"]["value"] > 0


def test_setup_and_window_cover_all_work(monkeypatch):
    """A stall inside one job of the window lengthens render_s_per_iter by
    at least its share; the same stall before the window goes to
    setup_s instead."""
    name = RENDER[0]
    kit = kits.program_kit()
    real = kit.photonbeam.render_photonbeam

    def runs(stall_at):
        calls = []

        def slow(*a, **kw):
            calls.append(1)
            if len(calls) == stall_at:
                time.sleep(1.0)
            return real(*a, **kw)
        monkeypatch.setattr(kit.photonbeam, "render_photonbeam", slow)
        t = time.perf_counter()
        cell = tiny_cell(name)
        e2e, *_ = cell.kind.run(cell, SEED, 0.05, False, "cpu", t)
        monkeypatch.setattr(kit.photonbeam, "render_photonbeam", real)
        return e2e
    runs(0)  # the process's first run pays its lazy initialisation
    base = runs(0)
    in_window = runs(2)  # call 1 is the set-up's warm-up job
    in_setup = runs(1)
    n_iter = tiny_cell(name).traffic["iterations_per_job"]
    assert in_window["render_s_per_iter"] >= (
        base["render_s_per_iter"] + 1.0 / (2 * n_iter))
    assert in_setup["setup_s"] >= in_window["setup_s"] + 0.9
    assert in_setup["render_s_per_iter"] < in_window["render_s_per_iter"]


@pytest.mark.parametrize("name", RENDER)
def test_an_altered_answer_fails_the_check(name, monkeypatch):
    """The timed path broken underneath: every image the program
    produces is off by 1% where it is produced."""
    kit = kits.program_kit()
    real = kit.photonbeam.render_photonbeam

    def altered(*a, **kw):
        image, stats = real(*a, **kw)
        return image * 1.01, stats
    monkeypatch.setattr(kit.photonbeam, "render_photonbeam", altered)
    out = bench_run.run(name, SEED, 0.2, False, device="cpu",
                        cell=tiny_cell(name))
    assert out["correct"] is False and out["failed"] >= 1


def test_a_nonfinite_image_fails_the_check(monkeypatch):
    kit = kits.program_kit()
    real = kit.photonbeam.render_photonbeam

    def broken(*a, **kw):
        image, stats = real(*a, **kw)
        image = image.clone()
        image[0, 0, 0] = float("nan")
        return image, stats
    monkeypatch.setattr(kit.photonbeam, "render_photonbeam", broken)
    out = bench_run.run(RENDER[0], SEED, 0.2, False, device="cpu",
                        cell=tiny_cell(RENDER[0]))
    assert out["correct"] is False


@pytest.mark.parametrize("name", RENDER)
def test_the_bfloat16_control_fails_the_check(name):
    """The reference with its gather's pair arithmetic in bfloat16, put in
    the program's place, reads above the cell's limit; the program reads
    below it."""
    cell = tiny_cell(name)
    jobs = cell.kind.jobs(cell.traffic, SEED)
    image = cell.kind.render_job(kits.program_kit(), cell, jobs[0], "cpu")
    checked, _, failed = cell.kind.check(
        cell, SEED, jobs, [image], "cpu", controls=(torch.bfloat16,))
    limit = cell.params["limits"]["pixel_gap"]
    assert checked["pixel_gap"]["value"] <= limit and failed == 0
    assert checked["control_gaps"]["torch.bfloat16"] > 3 * limit


@pytest.mark.parametrize("name", FIT)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_fit_step_fails_the_check(name, fault):
    """The timed path broken underneath: the optimizer's step leaves the
    state unchanged; the loss takes half of the film's rows, its mean over
    them; every image is off by 1% where it is produced."""
    cell = tiny_cell(name)
    undo = cell.kind.planted(kits.program_kit(), fault)
    try:
        out = bench_run.run(name, SEED, 0.2, False, device="cpu", cell=cell)
    finally:
        undo()
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("name", FIT)
def test_the_bfloat16_control_fails_the_fit_check(name):
    """The reference with its gathers' pair arithmetic in bfloat16, put in
    the program's place, fails one of the fit's compared numbers."""
    cell = tiny_cell(name)
    n = cell.params["check"]["steps"]
    ref = cell.kind.reference_fit(cell, SEED, n, "cpu")
    ctl = cell.kind.reference_fit(cell, SEED, n, "cpu",
                                  pair_dtype=torch.bfloat16)
    checked = cell.kind.compare(cell, ref, *ctl[:4])
    assert any(c["value"] > c["limit"] for c in checked.values())


@pytest.mark.parametrize("name", FIT)
def test_fit_window_covers_all_steps(name, monkeypatch):
    """A stall inside one step of the window lengthens fit_s_per_step;
    the same stall in a set-up step goes to setup_s instead."""
    kit = kits.program_kit()
    real = kit.inverse.make_inverse_train_step

    def runs(stall_at):
        calls = []

        def make(*a, **kw):
            step = real(*a, **kw)

            def slow(*sa, **skw):
                calls.append(1)
                if len(calls) == stall_at:
                    time.sleep(1.0)
                return step(*sa, **skw)
            return slow
        monkeypatch.setattr(kit.inverse, "make_inverse_train_step", make)
        cell = tiny_cell(name)
        e2e, _, _, _, _, steps, _ = cell.kind.run(cell, SEED, 0.05, False,
                                                  "cpu", time.perf_counter())
        monkeypatch.setattr(kit.inverse, "make_inverse_train_step", real)
        return e2e, steps
    n_setup = tiny_cell(name).params["setup_steps"]
    runs(0)  # the process's first run pays its lazy initialisation
    (in_window, steps), (in_setup, _) = runs(n_setup + 1), runs(1)
    assert in_window["fit_s_per_step"] >= 1.0 / steps
    assert in_setup["setup_s"] >= in_window["setup_s"] + 0.5
    assert in_setup["fit_s_per_step"] < in_window["fit_s_per_step"]


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
