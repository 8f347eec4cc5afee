"""Image I/O: PFM (byte-exact diffable), PNG, TGA, EXR — read and write
(counterpart of ``bre_tpu/io/image.py``).

pbrt's src/core/imageio.cpp — extension dispatch at :46-60 (read) /
:81-122 (write), PFM reader/writer at :~200-330, PNG via lodepng, TGA at
:~170, EXR via OpenEXR (read :124-162).  Host-side numpy (image I/O is not
device work); the files written are byte for byte the reference's.  Readers
return float32 linear radiance (H,W,3); LDR formats (PNG/TGA) are
inverse-gamma-corrected like pbrt's ReadImage (imageio.cpp:46-60).  PNG
scanlines are unfiltered by the native decoder
(``native/image_filters.cpp``); ``_png_unfilter_plain`` is its plain
version.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..native import png_unfilter_native

__all__ = [
    "write_image", "read_image", "write_pfm", "read_pfm", "write_png",
    "write_exr", "read_exr", "read_png", "read_tga",
]


def write_pfm(path, img: np.ndarray) -> None:
    """Write float32 RGB (H,W,3) or gray (H,W) PFM; scanlines bottom-up,
    little-endian (negative scale), matching pbrt's WriteImagePFM
    (imageio.cpp:~300-330)."""
    img = np.asarray(img, np.float32)
    color = img.ndim == 3
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1\n")  # little-endian
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    return np.flipud(img).copy()


def _gamma_encode(img: np.ndarray) -> np.ndarray:
    """sRGB gamma (pbrt GammaCorrect, pbrt.h:1086-1090)."""
    img = np.clip(img, 0.0, 1.0)
    return np.where(img <= 0.0031308, 12.92 * img, 1.055 * img ** (1.0 / 2.4) - 0.055)


def write_png(path, img: np.ndarray, gamma: bool = True) -> None:
    """Minimal RGB8 PNG encoder (replaces vendored lodepng, src/ext/lodepng).

    img: float (H,W,3) linear radiance (gamma-encoded here) or uint8.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.dtype != np.uint8:
        x = _gamma_encode(img.astype(np.float32)) if gamma else np.clip(img, 0, 1)
        img = (x * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def _exr_predict(raw: bytes) -> bytes:
    """OpenEXR's ZIP pre-filter (inverse of ``_exr_unpredict``): split bytes
    into two interleaved halves, then delta-encode (ImfZip.cpp compress)."""
    arr = np.frombuffer(raw, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    t = np.empty(n, np.uint8)
    t[:half] = arr[0::2]
    t[half:] = arr[1::2]
    d = t.astype(np.int32)
    d[1:] = d[1:] - t[:-1].astype(np.int32) + 128
    return (d % 256).astype(np.uint8).tobytes()


def write_exr(path, img: np.ndarray, compression: str = "zip") -> None:
    """Scanline EXR 2.0 writer, float32 RGB, ZIP (default) or uncompressed.

    Stands in for the OpenEXR submodule (reference .gitmodules:1-3,
    imageio.cpp:124-162); readable by any EXR tool.
    """
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    comp = {"none": 0, "zip": 3}[compression]
    lines_per_block = 16 if comp == 3 else 1

    def attr(name: bytes, typ: bytes, data: bytes) -> bytes:
        return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data

    def chan(name: bytes) -> bytes:
        # name, pixel type (2=float), pLinear, reserved, xSampling, ySampling
        return name + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)

    channels = chan(b"B") + chan(b"G") + chan(b"R") + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr(b"channels", b"chlist", channels)
        + attr(b"compression", b"compression", bytes([comp]))
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\x00")
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        nlines = min(lines_per_block, h - y0)
        raw = b"".join(
            img[y0 + line, :, 2].astype("<f4").tobytes()
            + img[y0 + line, :, 1].astype("<f4").tobytes()
            + img[y0 + line, :, 0].astype("<f4").tobytes()
            for line in range(nlines)
        )
        if comp == 3:
            packed = zlib.compress(_exr_predict(raw), 6)
            # OpenEXR stores raw when compression doesn't help
            data = packed if len(packed) < len(raw) else raw
        else:
            data = raw
        blocks.append(struct.pack("<ii", y0, len(data)) + data)
    data_start = len(magic) + len(header) + 8 * n_blocks
    offsets, off = [], data_start
    for blk in blocks:
        offsets.append(struct.pack("<Q", off))
        off += len(blk)
    Path(path).write_bytes(
        magic + header + b"".join(offsets) + b"".join(blocks))


def write_image(path, img: np.ndarray) -> None:
    """Dispatch by extension (imageio.cpp:81-122)."""
    s = str(path).lower()
    if s.endswith(".pfm"):
        write_pfm(path, img)
    elif s.endswith(".png"):
        write_png(path, img)
    elif s.endswith(".exr"):
        write_exr(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")


# ---------------------------------------------------------------------------
# Readers


def _gamma_decode(x: np.ndarray) -> np.ndarray:
    """Inverse sRGB gamma (pbrt InverseGammaCorrect, pbrt.h:1092-1096)."""
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _exr_unpredict(d: bytearray) -> bytes:
    """Undo OpenEXR's ZIP/RLE post-filter: delta predictor, then the
    two-half byte de-interleave (OpenEXR ImfZip.cpp / ImfRle.cpp)."""
    arr = np.frombuffer(bytes(d), np.uint8).astype(np.int32)
    # t[i] += t[i-1] - 128 as a cumsum: out[i] = cumsum(t)[i] - 128*i
    arr = ((np.cumsum(arr - 128) + 128) % 256).astype(np.uint8)
    n = arr.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half : half + n // 2]
    return out.tobytes()


def _exr_rle_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        count = struct.unpack_from("b", data, i)[0]
        i += 1
        if count < 0:
            out += data[i : i - count]
            i += -count
        else:
            out += data[i : i + 1] * (count + 1)
            i += 1
    return bytes(out)


def read_exr(path) -> np.ndarray:
    """Scanline EXR reader: NO/RLE/ZIPS/ZIP compression, half/float/uint
    channels.  Returns float32 (H,W,3) linear (R,G,B; Y-only broadcast).

    Covers the OpenEXR subset pbrt itself writes/reads (imageio.cpp:124-162);
    tiled and PIZ/B44/DWA files raise ValueError.
    """
    buf = Path(path).read_bytes()
    if struct.unpack_from("<I", buf, 0)[0] != 20000630:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack_from("<I", buf, 4)[0]
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    def read_cstr(p):
        end = buf.index(b"\x00", p)
        return buf[p:end].decode("latin-1"), end + 1

    # header attributes
    attrs = {}
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = read_cstr(pos)
        typ, pos = read_cstr(pos)
        size = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size

    # channels: list of (name, pixel_type) sorted as stored (alphabetical)
    chdata = attrs["channels"][1]
    channels = []
    cp = 0
    while chdata[cp] != 0:
        end = chdata.index(b"\x00", cp)
        cname = chdata[cp:end].decode("latin-1")
        ptype = struct.unpack_from("<i", chdata, end + 1)[0]  # 0 uint,1 half,2 float
        channels.append((cname, ptype))
        cp = end + 1 + 16
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    comp = attrs["compression"][1][0]  # 0 none, 1 rle, 2 zips, 3 zip
    if comp not in (0, 1, 2, 3):
        raise ValueError(f"{path}: EXR compression {comp} not supported")
    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16}[comp]

    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    dtypes = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
    bpp = {0: 4, 1: 2, 2: 4}
    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    row_bytes = sum(bpp[pt] for _, pt in channels) * w

    for off in offsets:
        y0 = struct.unpack_from("<i", buf, off)[0] - ymin
        size = struct.unpack_from("<i", buf, off + 4)[0]
        raw = buf[off + 8 : off + 8 + size]
        nlines = min(lines_per_block, h - y0)
        expect = row_bytes * nlines
        # OpenEXR rule: a block whose stored size equals the uncompressed
        # size is raw (compression didn't help) — no inflate, no predictor.
        if comp in (2, 3) and len(raw) != expect:
            raw = _exr_unpredict(bytearray(zlib.decompress(raw)))
        elif comp == 1 and len(raw) != expect:
            raw = _exr_unpredict(bytearray(_exr_rle_decode(raw)))
        p = 0
        for line in range(nlines):
            for cname, ptype in channels:
                nb = bpp[ptype] * w
                vals = np.frombuffer(raw[p : p + nb], dtypes[ptype]).astype(np.float32)
                planes[cname][y0 + line] = vals
                p += nb
    if all(k in planes for k in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], -1)
    if "Y" in planes:
        return np.repeat(planes["Y"][:, :, None], 3, axis=2)
    first = next(iter(planes.values()))
    return np.repeat(first[:, :, None], 3, axis=2)


def _png_unfilter_plain(raw: bytes, h: int, stride: int,
                        fbpp: int) -> np.ndarray:
    """Undo PNG scanline filters (types 0-4; fbpp = filter unit in bytes):
    the plain version of ``native.png_unfilter_native``, the reference's
    Python loop over the scanlines."""
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos : pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub
            cur = line.copy()
            for i in range(fbpp, stride):
                cur[i] = (cur[i] + cur[i - fbpp]) & 0xFF
        elif ft == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ft == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                a = cur[i - fbpp] if i >= fbpp else 0
                cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - fbpp] if i >= fbpp else 0
                c = prev[i - fbpp] if i >= fbpp else 0
                b = prev[i]
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(path, gamma: bool = True) -> np.ndarray:
    """PNG reader (non-interlaced; gray/RGB/palette/alpha, 8/16-bit).

    Replaces lodepng_decode (reference src/ext/lodepng); alpha is dropped
    and LDR values are linearized like pbrt's ReadImage.
    """
    buf = Path(path).read_bytes()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = bytearray()
    palette = None
    w = h = depth = ctype = interlace = None
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        tag = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += data
        elif tag == b"IEND":
            break
    if interlace:
        raise ValueError(f"{path}: interlaced PNG not supported")
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if depth == 8:
        fbpp = nch
        stride = w * nch
        px = png_unfilter_native(zlib.decompress(bytes(idat)), h, stride, fbpp)
        arr = px.reshape(h, w, nch).astype(np.float32) / 255.0
    elif depth == 16:
        fbpp = nch * 2
        stride = w * nch * 2
        px = png_unfilter_native(zlib.decompress(bytes(idat)), h, stride, fbpp)
        arr = (
            px.reshape(h, w * nch, 2).astype(np.uint16) @ np.array([256, 1], np.uint16)
        ).reshape(h, w, nch).astype(np.float32) / 65535.0
    elif depth in (1, 2, 4) and ctype in (0, 3):
        stride = (w * depth + 7) // 8
        px = png_unfilter_native(zlib.decompress(bytes(idat)), h, stride, 1)
        bits = np.unpackbits(px, axis=1)[:, : w * depth].reshape(h, w, depth)
        vals = bits @ (1 << np.arange(depth - 1, -1, -1))
        scale = 1.0 if ctype == 3 else 1.0 / ((1 << depth) - 1)
        arr = (vals[..., None]).astype(np.float32) * scale
        if ctype == 3:
            arr = arr.astype(np.int32)
    else:
        raise ValueError(f"{path}: PNG depth {depth}/color {ctype} not supported")
    if ctype == 3:
        idx = arr[..., 0].astype(np.int32) if arr.dtype != np.int32 else arr[..., 0]
        rgb = palette[idx].astype(np.float32) / 255.0
    elif ctype in (0, 4):
        rgb = np.repeat(arr[..., :1], 3, axis=2)
    else:
        rgb = arr[..., :3]
    return _gamma_decode(rgb).astype(np.float32) if gamma else rgb.astype(np.float32)


def read_tga(path, gamma: bool = True) -> np.ndarray:
    """TGA reader: types 2/3 (uncompressed BGR/gray) and 10/11 (RLE),
    16/24/32-bit color or 8-bit gray; honors the origin descriptor bit.
    Replaces reference src/ext/targa.{h,cpp} (ReadImageTGA imageio.cpp:~170).
    """
    buf = Path(path).read_bytes()
    idlen, cmap_type, imtype = buf[0], buf[1], buf[2]
    w, h = struct.unpack_from("<HH", buf, 12)
    bpp = buf[16]
    desc = buf[17]
    top_origin = bool(desc & 0x20)
    pos = 18 + idlen
    if cmap_type:
        cm_len = struct.unpack_from("<H", buf, 5)[0]
        cm_bpp = buf[7]
        pos += cm_len * ((cm_bpp + 7) // 8)
    nbytes = (bpp + 7) // 8
    npix = w * h
    if imtype in (2, 3):
        data = np.frombuffer(buf, np.uint8, npix * nbytes, pos)
    elif imtype in (10, 11):
        out = np.empty(npix * nbytes, np.uint8)
        oi = 0
        while oi < npix * nbytes:
            hdr = buf[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run packet
                out[oi : oi + count * nbytes] = np.tile(
                    np.frombuffer(buf, np.uint8, nbytes, pos), count)
                pos += nbytes
            else:  # raw packet
                out[oi : oi + count * nbytes] = np.frombuffer(
                    buf, np.uint8, count * nbytes, pos)
                pos += count * nbytes
            oi += count * nbytes
        data = out
    else:
        raise ValueError(f"{path}: TGA image type {imtype} not supported")
    px = data.reshape(h, w, nbytes)
    if bpp == 8:
        rgb = np.repeat(px, 3, axis=2).astype(np.float32) / 255.0
    elif bpp in (15, 16):
        v = px[..., 0].astype(np.uint16) | (px[..., 1].astype(np.uint16) << 8)
        rgb = np.stack(
            [(v >> 10) & 31, (v >> 5) & 31, v & 31], -1).astype(np.float32) / 31.0
    elif bpp in (24, 32):
        rgb = px[..., [2, 1, 0]].astype(np.float32) / 255.0  # BGR(A) -> RGB
    else:
        raise ValueError(f"{path}: TGA bpp {bpp} not supported")
    if not top_origin:
        rgb = rgb[::-1]
    return _gamma_decode(rgb).astype(np.float32) if gamma else rgb.astype(np.float32)


def read_image(path) -> np.ndarray:
    """Dispatch by extension (imageio.cpp:46-60); returns linear f32 RGB."""
    s = str(path).lower()
    if s.endswith(".pfm"):
        return read_pfm(path)
    if s.endswith(".exr"):
        return read_exr(path)
    if s.endswith(".png"):
        return read_png(path)
    if s.endswith(".tga"):
        return read_tga(path)
    raise ValueError(f"unsupported image extension for read: {path}")
