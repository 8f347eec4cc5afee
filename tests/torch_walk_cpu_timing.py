"""CPU time of the tri-BVH walk (``scene.intersect._tri_bvh_traverse``) as
the port runs it on the CPU, dropping the lanes that are done at each host
read, against the same trips run in lockstep over every lane (the card's
loop without its CUDA graphs); on the CPU (not a test: pytest collects only
test_*.py).

Run from the repository root:  python3 tests/torch_walk_cpu_timing.py

The scene is chip_smoke.py phase 36 (b)'s: examples/cornell_fog.pbrt's box
and fog with one shape of each kind and a level-5 Loop icosahedron (30,800
triangles, the tri-BVH).  Rays start at seeded points inside the box in
seeded directions; nearest hits and any-hit occlusion with no t_max, on
1,024, 4,096 and 16,384 rays, one thread.  Both loops' results are checked
equal bit for bit before they are timed.  Prints the best of 3 wall-clock
runs after one warm-up, in seconds, and their ratio.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bre_tpu_torch.scene import intersect as ISECT  # noqa: E402
from bre_tpu_torch.scene import parser as PARSER  # noqa: E402
from torch_parity import shapes_fog_pbrt  # noqa: E402


def lockstep(scene, o, d, t_min, t_max, any_hit):
    """The walk's trips over every lane until none is live, read every
    TRIPS_PER_READ trips as the port's loop reads."""
    tabs, w = ISECT._walk_state(scene, o, d, t_min, t_max)
    while bool((w["sp"] > 0).any()):
        for _ in range(ISECT.TRIPS_PER_READ):
            ISECT._trip(w, tabs, any_hit)
    return w["best_t"], w["best_i"]


def best(fn, n=3):
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    scene = PARSER.parse_string(shapes_fog_pbrt(16, 1, 256, 5),
                                device=cpu).build(device=cpu)
    print(f"{scene.n_triangles} triangles, tri-BVH "
          f"{scene.tri_bvh is not None}")
    rs = np.random.RandomState(0)
    for n in (1024, 4096, 16384):
        o = rs.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
        o[:, 1] += 1.0
        d = rs.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        t_min, t_max = torch.full((n,), 1e-4), torch.full((n,), 1e30)
        for any_hit in (False, True):
            args = (scene, o, d, t_min, t_max, any_hit)
            a, b = ISECT._tri_bvh_traverse(*args), lockstep(*args)
            same = torch.equal(a[0], b[0]) and (
                any_hit or torch.equal(a[1], b[1]))
            if not same:
                raise AssertionError(f"{n} rays, any_hit={any_hit}: the two "
                                     "loops differ")
            drop = best(lambda: ISECT._tri_bvh_traverse(*args))
            keep = best(lambda: lockstep(*args))
            print(f"{n} rays, {'any-hit' if any_hit else 'nearest'}: lanes "
                  f"dropped {drop:.4f} s, lockstep {keep:.4f} s "
                  f"({keep / drop:.2f}x), same bits")


if __name__ == "__main__":
    main()
