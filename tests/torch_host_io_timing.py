"""Host time of the port's scene and image readers against their other
versions, on the CPU (not a test: pytest collects only test_*.py).

Run from the repository root:  python3 tests/torch_host_io_timing.py

- the ``.pbrt`` lexer: the port's regex ``scene.parser.tokenize`` against
  the C++ lexer through ctypes (``bre_tpu.native.tokenize_native``, the
  source and binding the port would otherwise copy), on the largest scene
  in the repo (examples/smoke_hetero.pbrt, 231,590 B) and on
  examples/cornell_fog.pbrt, and ``parse_file`` on each (device="cpu");
- ``io.ply.read_ply`` (native) against ``_read_ply_python`` on a binary
  little-endian mesh of 500,000 vertices and 1,000,000 triangles and on an
  ASCII mesh of 50,000 of each, written from a seeded generator;
- the PNG unfilter, native against ``io.image._png_unfilter_plain``, on
  512x512 RGB and 1024x1024 RGBA scanlines of random bytes with filter
  types 0-4 in turn.

Each reader's output is checked equal to its counterpart's before it is
timed.  Prints the best of n wall-clock runs after one warm-up, in seconds.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bre_tpu.native import tokenize_native  # noqa: E402
from bre_tpu_torch.io import image as timg  # noqa: E402
from bre_tpu_torch.io import ply as tply  # noqa: E402
from bre_tpu_torch.native import png_unfilter_native  # noqa: E402
from bre_tpu_torch.scene import parser as tparser  # noqa: E402


def best(fn, *args, n=7):
    fn(*args)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    for path in ("examples/smoke_hetero.pbrt", "examples/cornell_fog.pbrt"):
        text = open(path).read()
        assert tokenize_native(text) == tparser.tokenize(text)
        print(f"tokenize {path}: regex {best(tparser.tokenize, text):.6f} s, "
              f"C++ lexer {best(tokenize_native, text):.6f} s; parse_file "
              f"{best(lambda p: tparser.parse_file(p, device='cpu'), path):.6f} s")
    rng = np.random.default_rng(0)
    verts = rng.standard_normal((500_000, 3)).astype(np.float32)
    tris = rng.integers(0, len(verts), (1_000_000, 3)).astype(np.int32)
    with tempfile.TemporaryDirectory() as d:
        binary = os.path.join(d, "binary.ply")
        tply.write_ply(binary, verts, tris)
        ascii_ = os.path.join(d, "ascii.ply")
        n = 50_000
        with open(ascii_, "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex {n}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    f"element face {n}\n"
                    "property list uchar int vertex_indices\nend_header\n")
            f.writelines(f"{x} {y} {z}\n" for x, y, z in verts[:n])
            f.writelines(f"3 {a} {b} {c}\n"
                         for a, b, c in rng.integers(0, n, (n, 3)))
        for name, path in (("binary 1M triangles", binary),
                           ("ASCII 50k triangles", ascii_)):
            a, b = tply.read_ply(path), tply._read_ply_python(path)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
            print(f"read_ply {name} ({os.path.getsize(path)} B): native "
                  f"{best(tply.read_ply, path, n=3):.6f} s, plain "
                  f"{best(tply._read_ply_python, path, n=3):.6f} s")
    for h, w, fbpp in ((512, 512, 3), (1024, 1024, 4)):
        stride = w * fbpp
        raw = b"".join(bytes([y % 5]) + rng.integers(0, 256, stride, np.uint8)
                       .tobytes() for y in range(h))
        assert np.array_equal(png_unfilter_native(raw, h, stride, fbpp),
                              timg._png_unfilter_plain(raw, h, stride, fbpp))
        print(f"png unfilter {w}x{h}x{fbpp}: native "
              f"{best(png_unfilter_native, raw, h, stride, fbpp, n=3):.6f} s, "
              f"plain {best(timg._png_unfilter_plain, raw, h, stride, fbpp, n=3):.6f} s")


if __name__ == "__main__":
    main()
