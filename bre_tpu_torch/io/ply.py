"""PLY mesh reading for the ``plymesh`` shape, and writing for the CLI's
``--toply`` (counterpart of ``bre_tpu/io/ply.py``).

pbrt's src/shapes/plymesh.cpp (CreatePLYMesh) reads vertex positions and
faces through the vendored rply (src/ext/rply.{h,c}).  Here ``read_ply``
is the native C++ reader (``native/ply_reader.cpp``, built on first use),
and ``_read_ply_python`` (struct/numpy) is its plain version, which the
tests hold it against.

Only positions + triangulated faces are extracted — the triangle SoA scene
derives normals/uv from geometry (scene/intersect.py), matching how the
rest of the pipeline treats tessellated shapes.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

from ..native import read_ply_native

_SCALAR = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}

_NP = {
    "char": np.int8, "int8": np.int8, "uchar": np.uint8, "uint8": np.uint8,
    "short": np.int16, "int16": np.int16, "ushort": np.uint16,
    "uint16": np.uint16, "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32, "float": np.float32,
    "float32": np.float32, "double": np.float64, "float64": np.float64,
}


def _read_ply_python(path) -> Tuple[np.ndarray, np.ndarray]:
    data = Path(path).read_bytes()
    # header is text up to end_header
    end = data.find(b"end_header")
    if end < 0 or not data.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    body_at = data.find(b"\n", end) + 1
    header = data[:end].decode("ascii", "replace").splitlines()

    fmt = None
    elements = []  # (name, count, [(prop_name, type, list_count_type|None)])
    for line in header:
        w = line.split()
        if not w or w[0] in ("ply", "comment", "obj_info"):
            continue
        if w[0] == "format":
            fmt = w[1]
        elif w[0] == "element":
            elements.append((w[1], int(w[2]), []))
        elif w[0] == "property":
            if w[1] == "list":
                elements[-1][2].append((w[4], w[3], w[2]))
            else:
                elements[-1][2].append((w[2], w[1], None))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"{path}: unsupported format {fmt}")

    verts = np.zeros((0, 3), np.float32)
    tris: list = []

    if fmt == "ascii":
        toks = data[body_at:].split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[2] is None for p in props):
                names = [p[0] for p in props]
                k = len(props)
                arr = np.array(toks[ti:ti + count * k], np.float64)
                ti += count * k
                arr = arr.reshape(count, k)
                verts = np.stack(
                    [arr[:, names.index(c)] for c in "xyz"], -1
                ).astype(np.float32)
            else:
                for _ in range(count):
                    for pname, ptype, pcount in props:
                        if pcount is None:
                            ti += 1
                        else:
                            n = int(float(toks[ti])); ti += 1
                            idx = [int(float(t)) for t in toks[ti:ti + n]]
                            ti += n
                            if name == "face" and pname in (
                                    "vertex_indices", "vertex_index"):
                                for k2 in range(2, len(idx)):
                                    tris.append(
                                        (idx[0], idx[k2 - 1], idx[k2]))
        return verts, np.asarray(tris, np.int32).reshape(-1, 3)

    bo = "<" if fmt == "binary_little_endian" else ">"
    off = body_at
    for name, count, props in elements:
        fixed = all(p[2] is None for p in props)
        if fixed:
            rec_fmt = bo + "".join(_SCALAR[p[1]][0] for p in props)
            rec_size = struct.calcsize(rec_fmt)
            if name == "vertex":
                names = [p[0] for p in props]
                dt = np.dtype({
                    "names": names,
                    "formats": [
                        np.dtype(_NP[p[1]]).newbyteorder(bo) for p in props],
                })
                arr = np.frombuffer(data, dt, count, off)
                verts = np.stack(
                    [arr[c].astype(np.float32) for c in "xyz"], -1)
                off += rec_size * count
            else:
                off += rec_size * count
        else:
            for _ in range(count):
                for pname, ptype, pcount in props:
                    if pcount is None:
                        off += _SCALAR[ptype][1]
                        continue
                    cfmt, csz = _SCALAR[pcount]
                    (n,) = struct.unpack_from(bo + cfmt, data, off)
                    off += csz
                    ifmt, isz = _SCALAR[ptype]
                    vals = struct.unpack_from(bo + str(n) + ifmt, data, off)
                    off += isz * n
                    if name == "face" and pname in (
                            "vertex_indices", "vertex_index"):
                        for k2 in range(2, n):
                            tris.append((vals[0], vals[k2 - 1], vals[k2]))
    return verts, np.asarray(tris, np.int32).reshape(-1, 3)


def write_ply(path, verts: np.ndarray, tris: np.ndarray) -> None:
    """Write a binary_little_endian PLY mesh (positions + triangle faces).

    The output of the CLI's --toply conversion (pbrt.cpp --toply routes big
    trianglemeshes into .ply files); round-trips through read_ply."""
    verts = np.ascontiguousarray(np.asarray(verts, np.float32).reshape(-1, 3))
    tris = np.asarray(tris, np.int32).reshape(-1, 3)
    hdr = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {verts.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {tris.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n"
    ).encode("ascii")
    body = bytearray(verts.astype("<f4").tobytes())
    counts = np.full((tris.shape[0], 1), 3, np.uint8)
    # interleave count byte + 3 int32 per face
    face_dt = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    faces = np.empty(tris.shape[0], face_dt)
    faces["n"] = counts[:, 0]
    faces["idx"] = tris.astype("<i4")
    body += faces.tobytes()
    Path(path).write_bytes(hdr + bytes(body))


def read_ply(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a PLY mesh -> (verts (nv,3) float32, tris (nt,3) int32) with
    the native reader; a file it cannot parse raises ValueError."""
    return read_ply_native(path)
