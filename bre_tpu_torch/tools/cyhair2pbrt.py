"""cyhair2pbrt: convert Cem Yuksel .hair files to pbrt curve shapes, the same
output text, byte for byte, as ``bre_tpu/tools/cyhair2pbrt.py``.

pbrt's src/tools/cyhair2pbrt/cyhair2pbrt.cpp reads the cyHair binary header
(magic "HAIR", strand/point counts, bitfield of present arrays, defaults)
and emits one ``Shape "curve"`` per strand segment, the polyline turned into
Bezier control points (a Catmull-Rom style pass).  Strands with fewer than
2 points are skipped (the degenerate-strand guard).  Binary in, text out:
no tensor work, so no device.
Usage: ``python -m bre_tpu_torch.tools.cyhair2pbrt in.hair out.pbrt``.
"""

from __future__ import annotations

import struct
import sys

_HAS_SEGMENTS = 1
_HAS_POINTS = 2
_HAS_THICKNESS = 4
_HAS_TRANSPARENCY = 8
_HAS_COLOR = 16


def read_cyhair(path: str):
    """Returns (strands, thickness_per_point or None).

    strands: list of (n_i, 3) float arrays of polyline points.
    """
    import numpy as np

    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"HAIR":
            raise ValueError(f"{path}: not a cyHair file (magic {magic!r})")
        n_strands, n_points, flags = struct.unpack("<III", f.read(12))
        d_segments, = struct.unpack("<I", f.read(4))
        d_thickness, = struct.unpack("<f", f.read(4))
        _d_transparency, = struct.unpack("<f", f.read(4))
        _d_color = struct.unpack("<fff", f.read(12))
        f.read(88)  # file info string

        if flags & _HAS_SEGMENTS:
            segments = np.frombuffer(f.read(2 * n_strands), "<u2").astype(int)
        else:
            segments = np.full(n_strands, d_segments, int)
        if not flags & _HAS_POINTS:
            raise ValueError("cyHair file has no points array")
        pts = np.frombuffer(f.read(12 * n_points), "<f4").reshape(-1, 3)
        thickness = None
        if flags & _HAS_THICKNESS:
            thickness = np.frombuffer(f.read(4 * n_points), "<f4")
        else:
            thickness = np.full(n_points, d_thickness, np.float32)

    strands = []
    thick = []
    off = 0
    for s in segments:
        n = int(s) + 1
        strands.append(pts[off:off + n])
        thick.append(thickness[off:off + n])
        off += n
    return strands, thick


def polyline_to_bezier(poly):
    """Catmull-Rom-through-points -> piecewise cubic Bezier control points
    (the conversion cyhair2pbrt.cpp performs on each strand)."""
    import numpy as np

    p = np.asarray(poly, np.float32)
    n = len(p)
    if n < 2:
        return []
    out = []
    for i in range(n - 1):
        p0 = p[max(i - 1, 0)]
        p1 = p[i]
        p2 = p[i + 1]
        p3 = p[min(i + 2, n - 1)]
        c1 = p1 + (p2 - p0) / 6.0
        c2 = p2 - (p3 - p1) / 6.0
        out.append(np.stack([p1, c1, c2, p2]))
    return out


def convert(path_in: str, path_out: str) -> int:
    """Write a .pbrt fragment of curve shapes; returns strand count."""
    strands, thick = read_cyhair(path_in)
    n = 0
    with open(path_out, "w") as f:
        for poly, th in zip(strands, thick):
            if len(poly) < 2:
                continue
            for seg_i, cp in enumerate(polyline_to_bezier(poly)):
                w0 = float(th[min(seg_i, len(th) - 1)])
                w1 = float(th[min(seg_i + 1, len(th) - 1)])
                pts = " ".join(f"{v:.6g}" for v in cp.reshape(-1))
                f.write(
                    f'Shape "curve" "string type" "cylinder" '
                    f'"point P" [ {pts} ] '
                    f'"float width0" {w0:.6g} "float width1" {w1:.6g}\n'
                )
            n += 1
    return n


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: cyhair2pbrt <input.hair> <output.pbrt>", file=sys.stderr)
        return 1
    n = convert(argv[0], argv[1])
    print(f"cyhair2pbrt: wrote {n} strands")
    return 0


if __name__ == "__main__":
    sys.exit(main())
