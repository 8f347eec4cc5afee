"""Finds everything a run needs by name: the cell's entry in
``BENCHMARK.json``, its workload file, its configuration (sizes and scene
recipe), its traffic mix and its per-layer metric readers.

Layout, all under ``benchmark/``:
- ``workloads/<cell>.json``: the cell's own parameters (the check's sample,
  the traced iterations, the limits of the compared numbers);
- ``configs/<config>.json`` and ``configs/<config>.py``: sizes, and the
  recipe that builds the scene with either side's ``SceneBuilder``;
- ``traffic/<mix>.json``: the mix's parameters, whose ``kind`` names
  ``kinds/<kind>.py``, the generator, runner and check of that kind;
- ``metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a cell, a configuration, a mix or a metric by adding
files and a ``BENCHMARK.json`` entry; nothing here lists them.  A new
kind of mix is a new ``kinds/<kind>.py`` with ``run(cell, seed, seconds,
trace, device, setup_start)`` and ``calibrate(cell, seeds, n_controls)``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import one file as a module of its own (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


@dataclasses.dataclass
class Cell:
    """One cell with everything that it names, loaded."""

    name: str
    entry: dict  # the cell's BENCHMARK.json entry
    params: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    recipe: ModuleType  # configs/<config>.py
    traffic: dict  # traffic/<mix>.json
    kind: ModuleType  # kinds/<kind>.py, named by the mix
    end_to_end: list  # BENCHMARK.json end_to_end entries this cell reports
    per_layer: list  # (entry, reader module) pairs this cell reports


def reports(metric: dict, cell: str) -> bool:
    """An end-to-end metric without ``workloads`` is reported everywhere."""
    return cell in metric.get("workloads", [cell])


def load_cell(cell: str, bench: dict | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json "
                       f"(cells: {', '.join(entries)})")
    entry = entries[check_name(cell)]
    params = load_json(bench_dir / "workloads" / f"{cell}.json")
    cfg_name = check_name(entry["config"])
    config = load_json(bench_dir / "configs" / f"{cfg_name}.json")
    recipe = load_module(bench_dir / "configs" / f"{cfg_name}.py", cfg_name)
    traffic = load_json(bench_dir / "traffic" /
                        f"{check_name(entry['traffic'])}.json")
    kind = load_module(bench_dir / "kinds" /
                       f"{check_name(traffic['kind'])}.py",
                       "kind." + traffic["kind"])
    e2e = [m for m in bench["end_to_end"] if reports(m, cell)]
    e2e_names = {m["name"] for m in e2e}
    layer = []
    for m in bench["per_layer"]:
        listed = m.get("workloads")
        if (cell in listed) if listed is not None else m["moves"] in e2e_names:
            mod = load_module(bench_dir / "metrics" /
                              f"{check_name(m['name'])}.py", m["name"])
            layer.append((m, mod))
    return Cell(cell, entry, params, config, recipe, traffic, kind, e2e,
                layer)
