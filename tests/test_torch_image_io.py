"""bre_tpu_torch's image I/O against bre_tpu's: the bytes each package
writes (PFM, PNG, EXR without and with ZIP compression) are identical, and
what each reads back (PFM, PNG with every filter type and bit depth, EXR
with float, half and uint channels under NO, RLE, ZIPS and ZIP
compression, TGA raw and RLE, every tests/data/*.pfm through read_image)
is identical.  The native PNG unfilter equals its plain version.  Every
comparison is exact: both packages run the same numpy arithmetic."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from bre_tpu.io import image as jimg
from bre_tpu_torch.io import image as timg
from bre_tpu_torch.native import png_unfilter_native
from test_image_io import _encode_png, _encode_tga

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(shape, seed=0, scale=4.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(np.float32)


WRITES = {
    "pfm rgb": ("pfm", lambda p, m, x: m.write_pfm(p, x), (7, 5, 3)),
    "pfm gray": ("pfm", lambda p, m, x: m.write_pfm(p, x), (6, 9)),
    "png float": ("png", lambda p, m, x: m.write_png(p, x), (9, 11, 3)),
    "png gray": ("png", lambda p, m, x: m.write_png(p, x), (5, 4)),
    "png no gamma": ("png", lambda p, m, x: m.write_png(p, x, gamma=False),
                     (6, 6, 3)),
    "png uint8": ("png", lambda p, m, x: m.write_png(
        p, (x * 60).astype(np.uint8)), (4, 7, 3)),
    "exr none": ("exr", lambda p, m, x: m.write_exr(p, x, "none"), (21, 13, 3)),
    "exr zip": ("exr", lambda p, m, x: m.write_exr(p, x, "zip"), (37, 13, 3)),
    "exr zip flat": ("exr", lambda p, m, x: m.write_exr(p, x * 0 + 0.25, "zip"),
                     (32, 64, 3)),
    "write_image pfm": ("pfm", lambda p, m, x: m.write_image(p, x), (3, 4, 3)),
    "write_image exr": ("exr", lambda p, m, x: m.write_image(p, x), (17, 3, 3)),
    "write_image png": ("png", lambda p, m, x: m.write_image(p, x), (3, 8, 3)),
}


@pytest.mark.parametrize("case", sorted(WRITES))
def test_written_bytes_and_reads_match(case, tmp_path):
    ext, write, shape = WRITES[case]
    x = _img(shape, seed=len(case))
    pt, pj = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    write(pt, timg, x)
    write(pj, jimg, x)
    assert pt.read_bytes() == pj.read_bytes()
    if ext != "pfm" or x.ndim == 3:  # read_image reads colour files
        a, b = timg.read_image(pt), jimg.read_image(pj)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if ext == "pfm":
        assert np.array_equal(timg.read_pfm(pt), x)


def test_write_image_rejects_unknown_extension(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        timg.write_image(tmp_path / "x.bmp", _img((2, 2, 3)))


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "tests", "data", "*.pfm"))))
def test_read_image_data_pfm(path):
    full = os.path.join(ROOT, path)
    a, b = timg.read_image(full), jimg.read_image(full)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


def _rle_encode(data: bytes) -> bytes:
    """OpenEXR's RLE: runs of 3+ equal bytes as (count-1, byte), the rest
    as literal runs (-count, bytes...)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += struct.pack("b", run - 1) + data[i:i + 1]
            i += run
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += struct.pack("b", -(j - i)) + data[i:j]
        i = j
    return bytes(out)


def _exr_file(img, ptype, comp, channels=(b"B", b"G", b"R")):
    """A scanline EXR with ``ptype`` channels (0 uint, 1 half, 2 float)
    under compression ``comp`` (0 none, 1 RLE, 2 ZIPS, 3 ZIP)."""
    h, w, _ = img.shape
    dt = {0: "<u4", 1: "<f2", 2: "<f4"}[ptype]
    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16}[comp]

    def attr(name, typ, data):
        return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data

    chlist = b"".join(c + b"\x00" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0,
                                                1, 1) for c in channels) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (attr(b"channels", b"chlist", chlist)
              + attr(b"compression", b"compression", bytes([comp]))
              + attr(b"dataWindow", b"box2i", box)
              + attr(b"displayWindow", b"box2i", box)
              + attr(b"lineOrder", b"lineOrder", b"\x00") + b"\x00")
    magic = struct.pack("<II", 20000630, 2)
    plane = {b"R": 0, b"G": 1, b"B": 2, b"Y": 0}
    blocks = []
    for y0 in range(0, h, lines_per_block):
        raw = b"".join(img[y, :, plane[c]].astype(dt).tobytes()
                       for y in range(y0, min(h, y0 + lines_per_block))
                       for c in channels)
        if comp in (2, 3):
            data = zlib.compress(jimg._exr_predict(raw))
        elif comp == 1:
            data = _rle_encode(jimg._exr_predict(raw))
        else:
            data = raw
        if len(data) >= len(raw):
            data = raw
        blocks.append(struct.pack("<ii", y0, len(data)) + data)
    start = len(magic) + len(header) + 8 * len(blocks)
    offsets, off = [], start
    for blk in blocks:
        offsets.append(struct.pack("<Q", off))
        off += len(blk)
    return magic + header + b"".join(offsets) + b"".join(blocks)


@pytest.mark.parametrize("ptype", [0, 1, 2], ids=["uint", "half", "float"])
@pytest.mark.parametrize("comp", [0, 1, 2, 3], ids=["none", "rle", "zips",
                                                    "zip"])
def test_read_exr_matches(tmp_path, ptype, comp):
    rng = np.random.RandomState(10 * ptype + comp)
    img = rng.rand(19, 7, 3)
    img[3:9] = 0.5  # runs for RLE
    img = (img * 1000).astype(np.uint32) if ptype == 0 else img.astype(
        np.float16 if ptype == 1 else np.float32)
    p = tmp_path / "t.exr"
    p.write_bytes(_exr_file(img, ptype, comp))
    a, b = timg.read_exr(p), jimg.read_exr(p)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(a, img.astype(np.float32))


def test_read_exr_luminance_only(tmp_path):
    img = np.random.RandomState(3).rand(5, 6, 3).astype(np.float32)
    p = tmp_path / "y.exr"
    p.write_bytes(_exr_file(img, 2, 0, channels=(b"Y",)))
    a, b = timg.read_exr(p), jimg.read_exr(p)
    assert np.array_equal(a, b) and np.array_equal(a[..., 2], img[..., 0])


@pytest.mark.parametrize("filters,nch", [([0, 1, 2, 3, 4], 3), ([4, 2], 4),
                                         ([3, 1, 0], 4)])
def test_read_png_filters_match(tmp_path, filters, nch):
    img8 = (np.random.RandomState(len(filters)).rand(9, 7, nch)
            * 255).astype(np.uint8)
    p = tmp_path / "t.png"
    p.write_bytes(_encode_png(img8, filters=filters))
    for gamma in (False, True):
        a = timg.read_png(p, gamma=gamma)
        b = jimg.read_png(p, gamma=gamma)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _png_chunks(w, h, depth, ctype, raw, plte=None):
    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + (chunk(b"PLTE", plte) if plte is not None else b"")
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray16", "palette4", "gray2", "graya8"])
def test_read_png_depths_match(tmp_path, kind):
    rng = np.random.RandomState(11)
    w, h = 6, 5
    if kind == "gray16":
        px = (rng.rand(h, w) * 65535).astype(">u2").tobytes()
        stride, depth, ctype, plte = w * 2, 16, 0, None
    elif kind == "graya8":
        px = (rng.rand(h, w, 2) * 255).astype(np.uint8).tobytes()
        stride, depth, ctype, plte = w * 2, 8, 4, None
    else:
        depth = 4 if kind == "palette4" else 2
        stride = (w * depth + 7) // 8
        px = (rng.rand(h, stride) * 255).astype(np.uint8).tobytes()
        ctype = 3 if kind == "palette4" else 0
        plte = (rng.rand(16, 3) * 255).astype(np.uint8).tobytes()
        plte = plte if ctype == 3 else None
    raw = b"".join(bytes([y % 5]) + px[y * stride:(y + 1) * stride]
                   for y in range(h))
    p = tmp_path / "t.png"
    p.write_bytes(_png_chunks(w, h, depth, ctype, raw, plte))
    a, b = timg.read_png(p), jimg.read_png(p)
    assert a.dtype == b.dtype and a.shape == (h, w, 3)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("top_origin", [False, True])
def test_read_tga_matches(tmp_path, rle, top_origin):
    img8 = (np.random.RandomState(7).rand(6, 5, 3) * 255).astype(np.uint8)
    img8[2:4, 1:4] = 77  # a run for RLE
    p = tmp_path / "t.tga"
    p.write_bytes(_encode_tga(img8, rle, top_origin))
    for gamma in (False, True):
        a, b = timg.read_tga(p, gamma=gamma), jimg.read_tga(p, gamma=gamma)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(timg.read_image(p), jimg.read_image(p))


@pytest.mark.parametrize("fbpp", [1, 3, 4, 8])
def test_png_unfilter_native_matches_plain(fbpp):
    rng = np.random.RandomState(fbpp)
    h, stride = 13, fbpp * 11
    rows = [bytes([y % 5]) + (rng.rand(stride) * 255).astype(np.uint8).tobytes()
            for y in range(h)]
    raw = b"".join(rows)
    native = png_unfilter_native(raw, h, stride, fbpp)
    plain = timg._png_unfilter_plain(raw, h, stride, fbpp)
    assert native.dtype == plain.dtype == np.uint8
    assert np.array_equal(native, plain)


def test_png_unfilter_native_rejects_bad_input():
    with pytest.raises(ValueError, match="filter type"):
        png_unfilter_native(bytes([7, 1, 2]), 1, 2, 1)
    with pytest.raises(ValueError, match="bytes"):
        png_unfilter_native(bytes([0, 1]), 1, 2, 1)
