"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program.  Module names are compared by
their top-level name, whole: ``bre_tpu_torch`` is not ``bre_tpu``."""

import ast
import subprocess
import sys

from harness import spec

FORBIDDEN = ("bre_tpu_torch", "bre_tpu", "jax", "jaxlib", "flax")

RUN_TINY = """
import sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import run
from tiny import tiny_cell
cell = tiny_cell({cell!r}, iterations=4)
run.run({cell!r}, 5, 0.1, {trace}, device="cpu", cell=cell)
print("FORBIDDEN", run.forbidden_modules())
"""

REFERENCE_ONLY = """
import sys
sys.path[:0] = [{bench!r}, {tests!r}]
from harness import kits, reference
from tiny import tiny_cell
cell = tiny_cell({cell!r})
if cell.traffic["kind"] == "render":
    job = cell.kind.published_job(cell.traffic)
    reference.render_pixels(kits.reference_kit(), cell, job, [[0, 1, 2]],
                            "cpu")
else:
    cell.kind.reference_fit(cell, 5, 1, "cpu")
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print("TOPS", [t for t in tops if t.startswith(("bre", "jax", "flax"))])
"""


def _py(code: str) -> str:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def _fmt(code, **kw):
    return code.format(bench=str(spec.BENCH_DIR), root=str(spec.ROOT),
                       tests=str(spec.BENCH_DIR / "tests"), **kw)


def test_forbidden_is_a_whole_name_compare():
    import run
    saved = dict(sys.modules)
    try:
        sys.modules["bre_tpu_torch_like"] = sys
        sys.modules["jaxish.sub"] = sys
        assert run.forbidden_modules() == []
        sys.modules["bre_tpu.core"] = sys
        assert run.forbidden_modules() == ["bre_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax_nor_the_jax_package():
    cell = spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"][0]
    for trace in (False, True):
        out = _py(_fmt(RUN_TINY, cell=cell["name"], trace=trace))
        assert "FORBIDDEN []" in out, out


def test_the_reference_loads_nothing_of_the_program():
    for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]:
        out = _py(_fmt(REFERENCE_ONLY, cell=w["name"]))
        assert "TOPS []" in out, out


def test_reference_sources_name_no_program_module():
    """Every import in the reference's sources is relative or of a module
    that is neither the program, JAX nor the JAX package."""
    for p in list((spec.BENCH_DIR / "pbref").rglob("*.py")) + [
            spec.BENCH_DIR / "harness" / "reference.py"]:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (p, n)
