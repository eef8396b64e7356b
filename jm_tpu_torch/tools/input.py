"""Source-frame input layer: planar and packed raw video readers (the
port's own copy of jm_tpu/tools/input.py).

Capability parity with lcommon/src/input.c (deinterleave_yuyv:198,
deinterleave_yvyu:238, deinterleave_uyvy:278, deinterleave_v210:318,
16-bit planar via symbol_size_in_bytes, buf2img bit-depth handling) —
vectorized numpy unpack instead of the reference's per-sample memcpy
loops. PixelFormat enum values match lcommon/inc/frame.h:30 (Interleaved
=1 + PixelFormat config, lencod/inc/configfile.h:345).

All packed formats are 4:2:2; outputs are planar (Y, U, V) with dtype
uint8 (bit_depth 8) or uint16 (>8). V210 is inherently 10-bit.
"""

from __future__ import annotations

import numpy as np

PF_UYVY = 0
PF_YUY2 = 1          # == YUYV
PF_YVYU = 2
PF_V210 = 4


def _frame_bytes(w: int, h: int, chroma_format: int, bit_depth: int,
                 pixel_format: int | None) -> int:
    if pixel_format == PF_V210:
        return w * h * 16 // 6          # 6 pixels per 16 bytes (4:2:2)
    sym = 1 if bit_depth <= 8 else 2
    if pixel_format in (PF_UYVY, PF_YUY2, PF_YVYU):
        return w * h * 2 * sym          # packed 4:2:2
    cw = w // 2
    ch = h // 2 if chroma_format == 1 else h
    return (w * h + 2 * cw * ch) * sym


def _unpack_packed422(raw: np.ndarray, w: int, h: int, pf: int):
    """UYVY/YUY2/YVYU -> planar 4:2:2 (input.c:198-316)."""
    q = raw.reshape(h, w // 2, 4)
    if pf == PF_UYVY:       # U Y V Y
        U, Y0, V, Y1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    elif pf == PF_YUY2:     # Y U Y V
        Y0, U, Y1, V = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    else:                   # YVYU: Y V Y U
        Y0, V, Y1, U = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    Y = np.empty((h, w), raw.dtype)
    Y[:, 0::2] = Y0
    Y[:, 1::2] = Y1
    return Y, np.ascontiguousarray(U), np.ascontiguousarray(V)


def _unpack_v210(raw: bytes, w: int, h: int):
    """V210 -> planar 10-bit 4:2:2 (input.c deinterleave_v210:318: three
    10-bit samples per 32-bit little-endian word, 6 pixels per 4 words,
    word sample order [Cb Y Cr][Y Cb Y][Cr Y Cb][Y Cr Y])."""
    words = np.frombuffer(raw, "<u4").reshape(-1, 4)
    s0 = words & 0x3FF
    s1 = (words >> 10) & 0x3FF
    s2 = (words >> 20) & 0x3FF
    n = words.shape[0]
    Y = np.empty((n, 6), np.uint16)
    U = np.empty((n, 3), np.uint16)
    V = np.empty((n, 3), np.uint16)
    U[:, 0] = s0[:, 0]
    Y[:, 0] = s1[:, 0]
    V[:, 0] = s2[:, 0]
    Y[:, 1] = s0[:, 1]
    U[:, 1] = s1[:, 1]
    Y[:, 2] = s2[:, 1]
    V[:, 1] = s0[:, 2]
    Y[:, 3] = s1[:, 2]
    U[:, 2] = s2[:, 2]
    Y[:, 4] = s0[:, 3]
    V[:, 2] = s1[:, 3]
    Y[:, 5] = s2[:, 3]
    return (Y.reshape(h, w), U.reshape(h, w // 2), V.reshape(h, w // 2))


def read_frames(path: str, w: int, h: int, n: int, *, start: int = 0,
                chroma_format: int = 1, bit_depth: int = 8,
                pixel_format: int | None = None):
    """Read n frames. pixel_format None = planar (YUV 4:2:0/4:2:2,
    8..14-bit little-endian); PF_* = packed 4:2:2 (always returned as
    planar 4:2:2). Returns [(Y, U, V)] with uint8/uint16 planes."""
    fsz = _frame_bytes(w, h, chroma_format, bit_depth, pixel_format)
    out = []
    with open(path, "rb") as fh:
        fh.seek(start * fsz)
        for _ in range(n):
            raw = fh.read(fsz)
            if len(raw) < fsz:
                break
            if pixel_format == PF_V210:
                out.append(_unpack_v210(raw, w, h))
                continue
            dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
            a = np.frombuffer(raw, dt)
            if pixel_format in (PF_UYVY, PF_YUY2, PF_YVYU):
                out.append(_unpack_packed422(a, w, h, pixel_format))
                continue
            cw = w // 2
            ch = h // 2 if chroma_format == 1 else h
            csz = cw * ch
            out.append((a[:w * h].reshape(h, w),
                        a[w * h:w * h + csz].reshape(ch, cw),
                        a[w * h + csz:].reshape(ch, cw)))
    return out
