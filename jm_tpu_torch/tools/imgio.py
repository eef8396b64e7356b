"""Image I/O and pre-processing, the port's copy of jm_tpu/tools/imgio.py:
TIFF sequences, RGB<->YUV, resize. numpy only, on the host.

Capability parity with lcommon/src/io_tiff.c (baseline uncompressed TIFF
read), lencod/src/cconv_yuv2rgb.c (BT.601 studio-range conversion,
YUV2RGB_YOFFSET constants K0..K4 :24-30), and lcommon/src/resize.c /
img_process.c (input filtering/resize), without external imaging
dependencies.
"""

from __future__ import annotations

import struct

import numpy as np

# TIFF tag ids (io_tiff.c readers)
_T_WIDTH, _T_HEIGHT, _T_BPS, _T_COMPRESSION = 256, 257, 258, 259
_T_PHOTOMETRIC, _T_STRIP_OFFSETS, _T_SPP = 262, 273, 277
_T_ROWS_PER_STRIP, _T_STRIP_COUNTS = 278, 279


def read_tiff(path: str) -> np.ndarray:
    """Baseline uncompressed TIFF -> (h, w) gray or (h, w, 3) RGB uint8."""
    data = open(path, "rb").read()
    if data[:2] == b"II":
        e = "<"
    elif data[:2] == b"MM":
        e = ">"
    else:
        raise ValueError("not a TIFF file")
    magic, ifd_off = struct.unpack_from(e + "HI", data, 2)
    if magic != 42:
        raise ValueError("bad TIFF magic")
    (n_tags,) = struct.unpack_from(e + "H", data, ifd_off)
    tags = {}
    for i in range(n_tags):
        tag, typ, cnt = struct.unpack_from(e + "HHI", data,
                                           ifd_off + 2 + 12 * i)
        voff = ifd_off + 2 + 12 * i + 8
        size = {1: 1, 3: 2, 4: 4}.get(typ, 4)
        if cnt * size <= 4:
            base = voff
        else:
            (base,) = struct.unpack_from(e + "I", data, voff)
        fmt = {1: "B", 3: "H", 4: "I"}.get(typ, "I")
        vals = struct.unpack_from(e + fmt * cnt, data, base)
        tags[tag] = vals
    if tags.get(_T_COMPRESSION, (1,))[0] != 1:
        raise NotImplementedError("compressed TIFF")
    w = tags[_T_WIDTH][0]
    h = tags[_T_HEIGHT][0]
    spp = tags.get(_T_SPP, (1,))[0]
    bps = tags.get(_T_BPS, (8,))[0]
    if bps != 8:
        raise NotImplementedError("only 8-bit TIFF")
    rows_per_strip = tags.get(_T_ROWS_PER_STRIP, (h,))[0]
    offsets = tags[_T_STRIP_OFFSETS]
    buf = bytearray()
    for i, off in enumerate(offsets):
        rows = min(rows_per_strip, h - i * rows_per_strip)
        buf += data[off:off + rows * w * spp]
    arr = np.frombuffer(bytes(buf), np.uint8)
    return arr.reshape(h, w) if spp == 1 else arr.reshape(h, w, spp)[..., :3]


def write_tiff(path: str, img: np.ndarray) -> None:
    """Minimal uncompressed little-endian TIFF writer (gray or RGB)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    pix = img.tobytes()
    hdr_off = 8
    data_off = hdr_off
    ifd_off = data_off + len(pix)
    tags = [
        (_T_WIDTH, 4, 1, w), (_T_HEIGHT, 4, 1, h),
        (_T_BPS, 3, 1, 8), (_T_COMPRESSION, 3, 1, 1),
        (_T_PHOTOMETRIC, 3, 1, 1 if spp == 1 else 2),
        (_T_STRIP_OFFSETS, 4, 1, data_off), (_T_SPP, 3, 1, spp),
        (_T_ROWS_PER_STRIP, 4, 1, h), (_T_STRIP_COUNTS, 4, 1, len(pix)),
    ]
    out = bytearray(struct.pack("<2sHI", b"II", 42, ifd_off))
    out += pix
    out += struct.pack("<H", len(tags))
    for tag, typ, cnt, val in tags:
        out += struct.pack("<HHII", tag, typ, cnt, val)
    out += struct.pack("<I", 0)
    open(path, "wb").write(bytes(out))


# ---- colour conversion (cconv_yuv2rgb.c K0..K4, studio range) ---------

_K0, _K1, _K2, _K3, _K4 = 1.164, 1.596, 0.391, 0.813, 2.018
_OFFSET_Y = 16


def rgb_to_yuv420(rgb: np.ndarray):
    """RGB (h, w, 3) uint8 -> (Y, U, V) planar 4:2:0 (BT.601 studio)."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = 0.257 * r + 0.504 * g + 0.098 * b + _OFFSET_Y
    u = -0.148 * r - 0.291 * g + 0.439 * b + 128.0
    v = 0.439 * r - 0.368 * g - 0.071 * b + 128.0
    Y = np.clip(np.rint(y), 0, 255).astype(np.uint8)
    # 4:2:0 subsample by 2x2 mean
    u2 = u.reshape(u.shape[0] // 2, 2, u.shape[1] // 2, 2).mean(axis=(1, 3))
    v2 = v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2).mean(axis=(1, 3))
    U = np.clip(np.rint(u2), 0, 255).astype(np.uint8)
    V = np.clip(np.rint(v2), 0, 255).astype(np.uint8)
    return Y, U, V


def yuv420_to_rgb(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """Inverse conversion (YUVtoRGB cconv_yuv2rgb.c:91)."""
    y = Y.astype(np.float64) - _OFFSET_Y
    u = np.repeat(np.repeat(U, 2, 0), 2, 1).astype(np.float64) - 128.0
    v = np.repeat(np.repeat(V, 2, 0), 2, 1).astype(np.float64) - 128.0
    r = _K0 * y + _K1 * v
    g = _K0 * y - _K2 * u - _K3 * v
    b = _K0 * y + _K4 * u
    return np.clip(np.rint(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


# ---- resize (lcommon/src/resize.c analog) -----------------------------

def resize_plane(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize of one 8-bit plane."""
    h, w = plane.shape
    if (h, w) == (out_h, out_w):
        return plane.copy()
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None]
    fx = np.clip(xs - x0, 0, 1)[None, :]
    p = plane.astype(np.float64)
    top = p[y0][:, x0] * (1 - fx) + p[y0][:, x1] * fx
    bot = p[y1][:, x0] * (1 - fx) + p[y1][:, x1] * fx
    return np.clip(np.rint(top * (1 - fy) + bot * fy), 0, 255) \
        .astype(np.uint8)


def resize_yuv420(Y, U, V, out_h: int, out_w: int):
    return (resize_plane(Y, out_h, out_w),
            resize_plane(U, out_h // 2, out_w // 2),
            resize_plane(V, out_h // 2, out_w // 2))


def read_tiff_sequence(pattern: str, n: int, start: int = 0):
    """Read a printf-style TIFF sequence as 4:2:0 frames (RGB converted,
    gray used as luma with neutral chroma)."""
    frames = []
    for i in range(start, start + n):
        img = read_tiff(pattern % i if "%" in pattern else pattern)
        if img.ndim == 3:
            frames.append(rgb_to_yuv420(img))
        else:
            h, w = img.shape
            frames.append((img, np.full((h // 2, w // 2), 128, np.uint8),
                           np.full((h // 2, w // 2), 128, np.uint8)))
    return frames
