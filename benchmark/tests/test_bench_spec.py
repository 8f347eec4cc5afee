"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of cells, configurations, mixes and metrics by name."""

import json
import re
import shutil

import pytest

from harness import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
TEXT_RE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT_RE.match(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT_RE.match(c["source"]) and TEXT_RE.match(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            spec.check_name(k)
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT_RE.match(w["why"])
        spec.check_name(w["config"]), spec.check_name(w["traffic"])
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(("metric", m["name"]))
    for _, n in names:
        spec.check_name(n)
    assert len(names) == len(set(names))


def test_configs_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


def test_cells_and_bounds():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(pairs) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        assert TEXT_RE.match(m["layer"])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m, _ in cell.per_layer:
            assert m["moves"] in e2e


def test_metric_files_agree_with_benchmark_json():
    for m in BENCH["per_layer"]:
        mod = spec.load_module(spec.BENCH_DIR / "metrics" / f"{m['name']}.py",
                               m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                     m["moves"])
        assert callable(mod.read)


def test_harness_names_no_cell():
    """The general code knows no cell, configuration, mix or metric by
    name: those are files found from BENCHMARK.json."""
    code = "".join(p.read_text() for d in ("harness", "kinds")
                   for p in (spec.BENCH_DIR / d).glob("*.py"))
    code += (spec.BENCH_DIR / "run.py").read_text()
    for kind in ("configs", "workloads", "per_layer"):
        for e in BENCH[kind]:
            assert e["name"] not in code, e["name"]


def test_new_cell_and_metric_are_files(tmp_path):
    """A cell and a metric are added by new files and BENCHMARK.json
    entries alone: the harness picks them up unedited."""
    for sub in ("workloads", "configs", "traffic", "metrics", "kinds"):
        shutil.copytree(spec.BENCH_DIR / sub, tmp_path / sub)
    base = BENCH["workloads"][0]
    (tmp_path / "workloads" / "throwaway.cell.json").write_text(
        (spec.BENCH_DIR / "workloads" / f"{base['name']}.json").read_text())
    (tmp_path / "metrics" / "throwaway_ms.render.py").write_text(
        'UNIT = "ms"\nLAYER = "device"\nMOVES = "render_s_per_iter"\n\n\n'
        "def read(rd):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(base, name="throwaway.cell"))
    bench["per_layer"].append(dict(
        name="throwaway_ms.render", unit="ms", better="lower",
        source="device_trace", layer="device", moves="render_s_per_iter",
        workloads=["throwaway.cell"]))
    cell = spec.load_cell("throwaway.cell", bench=bench, bench_dir=tmp_path)
    names = [m["name"] for m, _ in cell.per_layer]
    assert names == ["throwaway_ms.render"]
    assert cell.per_layer[0][1].read(None) == 1.0
    assert cell.config["name"] == base["config"]
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", bench=bench, bench_dir=tmp_path)


def test_new_mix_kind_is_a_file(tmp_path):
    """A mix of a new kind brings its generator and runner as a file of
    its own, ``kinds/<kind>.py``, found by the mix's ``kind``."""
    for sub in ("workloads", "configs", "traffic", "metrics", "kinds"):
        shutil.copytree(spec.BENCH_DIR / sub, tmp_path / sub)
    base = BENCH["workloads"][0]
    (tmp_path / "traffic" / "throwaway.json").write_text(
        json.dumps(dict(kind="throwaway")))
    (tmp_path / "kinds" / "throwaway.py").write_text(
        "def run(cell, seed, seconds, trace, device, setup_start):\n"
        "    return dict(setup_s=1.0), {}, {}, None, {}, 1, 0\n")
    (tmp_path / "workloads" / "throwaway.cell.json").write_text("{}")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(base, name="throwaway.cell",
                                   traffic="throwaway"))
    cell = spec.load_cell("throwaway.cell", bench=bench, bench_dir=tmp_path)
    assert cell.kind.run(cell, 1, 1.0, False, "cpu", 0.0)[0] == dict(
        setup_s=1.0)
