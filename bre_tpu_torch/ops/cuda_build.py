"""Build and load the port's CUDA kernels.

The sources in ``bre_tpu_torch/csrc/`` are compiled at first use, one
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
-c`` per source, all started together, and linked with ``nvcc -shared`` into
``bre_tpu_torch/_build/<source hash>/``, a shared library with a plain C
interface that ``ctypes`` loads.  The build is keyed by a hash of the
sources, the headers and the flags, so an edited file rebuilds and an
unchanged tree loads the cached library.  No fast-math: the gather's exp,
log and divisions must stay close to the reference's.

Nothing here runs at import time; a missing ``nvcc`` raises a RuntimeError
when a kernel is first needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("beam_gather_fwd.cu", "beam_gather_bwd.cu")
HEADERS = ("pair_math.cuh", "split_sweep.cuh", "bulk_copy.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libbre_tpu_torch_kernels.so"

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last nvcc run
# ptxas's report of the last build (registers, shared memory and spills per
# kernel instance, from -Xptxas -v)
build_log: Optional[str] = None


def find_nvcc() -> str:
    """nvcc from PATH, $CUDA_HOME/bin or /usr/local/cuda/bin."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the bre_tpu_torch CUDA kernels are built from csrc/ at first use and "
        "need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the sources unless the hashed build already exists; returns
    the library path.  The library is written to a temporary name and moved
    into place, so concurrent builders never load a partial file."""
    global build_seconds, build_log
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        t0 = time.perf_counter()
        objs = [os.path.join(tmp_dir, Path(src).stem + ".o") for src in SOURCES]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / src)]
            for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in compiles]
        outs = [proc.communicate() for proc in procs]
        for cmd, proc, (out, err) in zip(compiles, procs, outs):
            _check_nvcc(cmd, proc.returncode, out, err)
        build_log = "".join(out + err for out, err in outs)
        tmp = os.path.join(tmp_dir, LIB_NAME)
        link = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, proc.returncode, proc.stdout, proc.stderr)
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, lib_path)
    return lib_path


def _check_nvcc(cmd, returncode, out, err) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{out}\n{err}")


def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's types."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bre_cuda_error_string.argtypes = [i]
    lib.bre_cuda_error_string.restype = ctypes.c_char_p
    # rays, beams, scalars, mask, staged, partial, out, n_tiles, n_chunks,
    # n_splits, hetero, stream
    lib.bre_gather_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.bre_gather_forward.restype = i
    # rays, beams, scalars, idx, run_start, staged, partial, out, n_tiles,
    # n_chunks, n_splits, hetero, stream
    lib.bre_gather_sparse.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.bre_gather_sparse.restype = i
    # rays, beams, scalars, mask, ct, staged_beams, partial, d_rays, d_beams,
    # n_tiles, n_chunks, n_splits, want_extras, hetero, stream
    lib.bre_gather_backward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                        i, p]
    lib.bre_gather_backward.restype = i
    # rays, beams, scalars, ct, idx_t, run_start, idx_c, chunk_start,
    # staged_beams, partial, d_rays, d_beams, n_tiles, n_chunks, n_splits,
    # want_extras, stream
    lib.bre_gather_backward_sparse.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                               p, p, i, i, i, i, p]
    lib.bre_gather_backward_sparse.restype = i
    # rays, beams, scalars, ct, d_rays, d_beams, n_tiles, n_chunks, stream
    lib.bre_gather_backward_twopass.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.bre_gather_backward_twopass.restype = i
    _lib = lib
    return lib


def check_status(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.bre_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
