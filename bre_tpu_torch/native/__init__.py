"""The host-side C++ pieces of mesh and image input, bound with ctypes
(counterpart of ``bre_tpu/native/__init__.py``).

Two sources sit beside this file: the PLY reader (``ply_reader.cpp``) and
the PNG scanline unfilter (``image_filters.cpp``), each with the C
signature the reference binds.  Each is compiled at first use with
``g++ -O2 -shared -fPIC`` into ``bre_tpu_torch/_build/native/<hash>/``,
keyed by a hash of its source and the flags, so an edited source rebuilds
and an unchanged one loads the cached library.  A failed build raises a
RuntimeError quoting g++'s output; nothing falls back to the plain Python
versions, which stay beside their callers (``io.ply._read_ply_python``,
``io.image._png_unfilter_plain``) for the tests.  The reference's third
source, a ``.pbrt`` lexer, is not kept: the regex lexer is as fast on the
largest scene in the repo (``scene.parser.tokenize``).
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def build_library(source: str) -> Path:
    """Compile ``source`` unless its hashed build exists; returns the path of
    the shared library.  It is written under a temporary name and moved into
    place, so concurrent builders never load a partial file."""
    src = SRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib_path = out_dir / f"lib{src.stem}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        tmp = os.path.join(tmp_dir, lib_path.name)
        cmd = ["g++", *GXX_FLAGS, str(src), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: {source} is built at first "
                               "use and needs a C++ compiler") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def _load(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(source)))
        i64, p = ctypes.c_int64, ctypes.POINTER
        if source == "ply_reader.cpp":
            lib.ply_load.restype = ctypes.c_void_p
            lib.ply_load.argtypes = [ctypes.c_char_p, p(i64), p(i64)]
            lib.ply_copy.restype = None
            lib.ply_copy.argtypes = [ctypes.c_void_p, p(ctypes.c_float),
                                     p(ctypes.c_int32)]
            lib.ply_free.restype = None
            lib.ply_free.argtypes = [ctypes.c_void_p]
        else:
            lib.png_unfilter.restype = i64
            lib.png_unfilter.argtypes = [p(ctypes.c_uint8), i64, i64, i64,
                                         p(ctypes.c_uint8)]
        _libs[source] = lib
    return lib


def read_ply_native(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a PLY mesh with the C++ reader: (verts (nv,3) float32, tris
    (nt,3) int32).  A file it cannot parse raises ValueError."""
    lib = _load("ply_reader.cpp")
    nv = ctypes.c_int64(0)
    nt = ctypes.c_int64(0)
    h = lib.ply_load(str(path).encode(), ctypes.byref(nv), ctypes.byref(nt))
    if not h:
        raise ValueError(f"{path}: not a PLY mesh the reader can parse")
    try:
        verts = np.empty((nv.value, 3), np.float32)
        tris = np.empty((nt.value, 3), np.int32)
        lib.ply_copy(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.ply_free(h)
    return verts, tris


def png_unfilter_native(raw: bytes, h: int, stride: int,
                        fbpp: int) -> np.ndarray:
    """Undo PNG scanline filters with the C++ decoder: ``raw`` holds ``h``
    rows of a filter-type byte and ``stride`` bytes; returns (h, stride)
    uint8.  A wrong length or a bad filter type raises ValueError."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, not "
                         f"{h} x ({stride} + 1)")
    lib = _load("image_filters.cpp")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    rc = lib.png_unfilter(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          h, stride, fbpp,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError("bad PNG filter type")
    return out
