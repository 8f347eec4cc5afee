"""bre_tpu_torch's PLY I/O and scene pretty-printer against bre_tpu's.

``read_ply`` (the native reader) and ``_read_ply_python`` (its plain
version) return exactly the reference reader's arrays on ASCII and
binary little- and big-endian files; ``write_ply`` writes the reference's
bytes; ``cat_scene`` returns the reference's string for every .pbrt in the
repo, and with ``toply_dir`` writes byte-identical PLY files.  Every
comparison is exact."""

import glob
import os

import numpy as np
import pytest

from bre_tpu.io import ply as jply
from bre_tpu.scene.cat import cat_scene as jcat
from bre_tpu_torch.io import ply as tply
from bre_tpu_torch.scene.cat import cat_scene as tcat
from test_ply import _write_ascii, _write_binary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_PBRT = sorted(os.path.relpath(p, ROOT) for p in
                  glob.glob(os.path.join(ROOT, "examples", "*.pbrt"))
                  + glob.glob(os.path.join(ROOT, "tests", "data", "*.pbrt")))
WRITERS = {"ascii": (_write_ascii, {}), "binary le": (_write_binary, {}),
           "binary be": (_write_binary, {"big": True})}


def _grid_mesh(n=12, seed=0):
    """An n x n grid of quads as 2 n^2 triangles, jittered heights."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.linspace(-1, 1, n + 1), np.linspace(-1, 1, n + 1))
    pts = np.stack([xs, ys, rng.rand(*xs.shape) * 0.1], -1).reshape(-1, 3)
    idx = []
    for j in range(n):
        for i in range(n):
            v = j * (n + 1) + i
            idx += [[v, v + 1, v + n + 2], [v, v + n + 2, v + n + 1]]
    return pts.astype(np.float32), np.asarray(idx, np.int32)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
@pytest.mark.parametrize("reader", ["native", "plain"])
def test_read_ply_matches_reference(tmp_path, fmt, reader):
    writer, kw = WRITERS[fmt]
    p = tmp_path / "m.ply"
    writer(p, **kw)
    read = tply.read_ply if reader == "native" else tply._read_ply_python
    v, t = read(p)
    jv, jt = jply.read_ply(p)
    assert v.dtype == jv.dtype == np.float32 and t.dtype == jt.dtype == np.int32
    assert np.array_equal(v, jv) and np.array_equal(t, jt)
    assert t.shape == (3, 3)


def test_read_ply_native_rejects_garbage(tmp_path):
    p = tmp_path / "bad.ply"
    p.write_bytes(b"not a ply file at all")
    with pytest.raises(ValueError, match="PLY"):
        tply.read_ply(p)


def test_write_ply_bytes_match_reference(tmp_path):
    pts, idx = _grid_mesh(5)
    tply.write_ply(tmp_path / "t.ply", pts, idx)
    jply.write_ply(tmp_path / "j.ply", pts, idx)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    v, t = tply.read_ply(tmp_path / "t.ply")
    assert np.array_equal(v, pts) and np.array_equal(t, idx)


@pytest.mark.parametrize("path", ALL_PBRT)
def test_cat_matches_reference(path):
    full = os.path.join(ROOT, path)
    text = open(full).read()
    inc = os.path.dirname(full)
    assert tcat(text, include_dir=inc) == jcat(text, include_dir=inc)


def _toply_scene(directory):
    pts, idx = _grid_mesh(16)  # 512 triangles: converted
    small_pts, small_idx = _grid_mesh(2)  # 8 triangles: kept inline
    fmt = lambda a: " ".join(str(v) for v in a.reshape(-1))  # noqa: E731
    (directory / "inc.pbrt").write_text(
        'Shape "trianglemesh" "integer indices" [ %s ] "point P" [ %s ]\n'
        % (fmt(small_idx), fmt(small_pts)))
    return ("LookAt 0 0 -3  0 0 0  0 1 0\nCamera \"perspective\" \"float fov\" 45\n"
            "WorldBegin\nAttributeBegin\n  Material \"matte\"\n"
            '  Shape "trianglemesh" "integer indices" [ %s ] "point P" [ %s ]\n'
            '  Include "inc.pbrt"\nAttributeEnd\nWorldEnd\n'
            % (fmt(idx), fmt(pts)))


def test_toply_matches_reference(tmp_path):
    outs = {}
    for name, cat in (("t", tcat), ("j", jcat)):
        d = tmp_path / name
        d.mkdir()
        text = _toply_scene(d)
        outs[name] = (cat(text, include_dir=d, toply_dir=d),
                      {p.name: p.read_bytes() for p in d.glob("*.ply")})
    assert outs["t"] == outs["j"]
    assert list(outs["t"][1]) == ["mesh_00001.ply"]
    assert 'Shape "plymesh"' in outs["t"][0]
