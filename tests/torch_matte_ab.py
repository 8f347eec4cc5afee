"""s/iter of three matte scenes through ``bre_tpu_torch.cli.main`` for two
source trees in turns, on one card: the CLI's config 2
(``examples/cornell_fog.pbrt``, 16 iterations), the vsppm golden scene
(``tests/data/vsppm_golden.pbrt --kernel compat``, 8 iterations) and
config 1 (``examples/fog_cube.pbrt --kernel compat``, 8 iterations), each
timed as ``chip_smoke.py`` phases 29-31 time them: wall / iterations of
one ``cli.main`` call in a warm process (parse, build and PFM write
included).  Not a test.

    python3 tests/torch_matte_ab.py parent=.scratch/parent new=. [rounds=2]

Each tree runs in its own process with the tree's root as its working
directory, in the order first, second, second, first (``rounds`` times
that pair of turns); each process warms up on one ``--quick`` render of
each scene before it times them.  Prints one JSON line: per tree the
s/iter of every turn, and the medians; details to
``chiprun_out/matte_ab.json``.
"""

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SCENES = {
    "cli_config2": ("examples/cornell_fog.pbrt", []),
    "vsppm_golden": ("tests/data/vsppm_golden.pbrt", ["--kernel", "compat"]),
    "config1_compat": ("examples/fog_cube.pbrt", ["--kernel", "compat"]),
}


def child():
    """Time the scenes in this process, the tree in the working directory
    on sys.path first."""
    sys.path.insert(0, os.getcwd())
    import torch
    from bre_tpu_torch import cli
    from bre_tpu_torch.scene import parser

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pfm = os.path.join(tmp, "x.pfm")
        for quick in (True, False):
            for name, (scene, args) in SCENES.items():
                buf = io.StringIO()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main([scene, "-o", pfm] + args
                                  + (["--quick"] if quick else []))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise SystemExit(f"{name}: cli.main returned {rc}")
                if not quick:
                    ps = parser.parse_file(scene, device="cpu")
                    config = (cli.vsppm_config
                              if ps.integrator_name == "vsppm"
                              else cli.photonbeam_config)
                    iters = config(ps).iterations
                    out[name] = dict(wall_s=wall, iterations=iters,
                                     s_per_iter=wall / iters)
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:] == ["--child"]:
        return child()
    trees = [a.split("=", 1) for a in sys.argv[1:] if "=" in a
             and not a.startswith("rounds=")]
    rounds = int(next((a.split("=")[1] for a in sys.argv[1:]
                       if a.startswith("rounds=")), 1))
    if len(trees) != 2:
        raise SystemExit(__doc__)
    me = os.path.abspath(__file__)
    order = [trees[0], trees[1], trees[1], trees[0]] * rounds
    runs = {label: [] for label, _ in trees}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for label, path in order:
        res = subprocess.run([sys.executable, me, "--child"], cwd=path,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"{label}: {res.stderr[-3000:]}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs[label].append(got)
        print(label, {k: round(v["s_per_iter"], 4) for k, v in got.items()},
              flush=True)
    summary = {"card": smi}
    for label, got in runs.items():
        summary[label] = {
            name: dict(s_per_iter=[g[name]["s_per_iter"] for g in got],
                       median=statistics.median(g[name]["s_per_iter"]
                                                for g in got))
            for name in SCENES}
    root = os.path.dirname(os.path.dirname(me))
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "matte_ab.json"), "w") as f:
        json.dump(dict(summary=summary, runs=runs), f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
