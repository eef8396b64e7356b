"""Intra prediction on the host (spec 8.3): 4x4 and 8x8 luma (9 modes),
16x16 luma (4 modes), chroma 8x8 (4 modes); numpy twin of predict_i4,
predict_i8, predict_i16 and predict_chroma of jm_tpu/ops/intra.py
(ldecod/src/intra4x4_pred_normal.c, intra16x16_pred_normal.c,
intra_chroma_pred.c). The decoder's Reconstructor calls them per block;
the encoder's batched I frame is ops/intra.py.
"""

from __future__ import annotations

import numpy as np

# 4x4 luma intra modes
I4_VERT, I4_HOR, I4_DC, I4_DDL, I4_DDR, I4_VR, I4_HD, I4_VL, I4_HU = range(9)
# 16x16 luma modes
I16_VERT, I16_HOR, I16_DC, I16_PLANE = range(4)
# chroma modes
C_DC, C_HOR, C_VERT, C_PLANE = range(4)


def predict_i4(mode: int, top: np.ndarray, left: np.ndarray, corner: int,
               avail_top: bool, avail_left: bool,
               dc: int = 128) -> np.ndarray:
    """One 4x4 intra prediction. top: 8 samples A..H (up + up-right, the
    caller already substitutes top[4:8]=top[3] when up-right is unavailable),
    left: 4 samples, corner: sample M. Returns (4,4) int32.
    """
    t = top.astype(np.int32)
    l = left.astype(np.int32)
    m = int(corner)
    p = np.zeros((4, 4), np.int32)
    if mode == I4_VERT:
        p[:, :] = t[:4][None, :]
    elif mode == I4_HOR:
        p[:, :] = l[:, None]
    elif mode == I4_DC:
        if avail_top and avail_left:
            p[:, :] = (int(t[:4].sum()) + int(l.sum()) + 4) >> 3
        elif avail_top:
            p[:, :] = (int(t[:4].sum()) + 2) >> 2
        elif avail_left:
            p[:, :] = (int(l.sum()) + 2) >> 2
        else:
            p[:, :] = dc
    elif mode == I4_DDL:
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
    elif mode == I4_DDR:
        # tt[i+1] == p[i,-1] so index -1 resolves to the corner sample M
        tt = np.concatenate([[m], t])
        ll = np.concatenate([[m], l])
        for y in range(4):
            for x in range(4):
                if x > y:
                    p[y, x] = (tt[x - y - 1] + 2 * tt[x - y] + tt[x - y + 1] + 2) >> 2
                elif x < y:
                    p[y, x] = (ll[y - x - 1] + 2 * ll[y - x] + ll[y - x + 1] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
    elif mode == I4_VR:
        tt = np.concatenate([[m], t])
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                k = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (tt[k] + tt[k + 1] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (tt[k - 1] + 2 * tt[k] + tt[k + 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * m + t[0] + 2) >> 2
                else:
                    ll = np.concatenate([[m], l])
                    p[y, x] = (ll[y] + 2 * ll[y - 1] + ll[y - 2] + 2) >> 2
    elif mode == I4_HD:
        ll = np.concatenate([[m], l])
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                k = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (ll[k] + ll[k + 1] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (ll[k - 1] + 2 * ll[k] + ll[k + 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
                else:
                    tt2 = np.concatenate([[m], t])
                    p[y, x] = (tt2[x] + 2 * tt2[x - 1] + tt2[x - 2] + 2) >> 2
    elif mode == I4_VL:
        for y in range(4):
            for x in range(4):
                if y % 2 == 0:
                    p[y, x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                               + t[x + (y >> 1) + 2] + 2) >> 2
    elif mode == I4_HU:
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z > 5:
                    p[y, x] = l[3]
                elif z == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                elif z % 2 == 0:
                    p[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                               + l[y + (x >> 1) + 2] + 2) >> 2
    else:
        raise ValueError(f"bad intra4x4 mode {mode}")
    return p


def _i4_weights() -> np.ndarray:
    """The 4x4 directional modes as weights over the 13 edge samples
    E = (M, A..H, I..L), in quarters: each predicted sample of mode m is
    (W[m] @ E + 2) >> 2, the formulas of predict_i4 with a copy weighted
    4 and a two-tap (a + b + 1) >> 1 as (2a + 2b + 2) >> 2 (DC, which
    depends on the neighbours' availability, is left zero)."""
    w = np.zeros((9, 4, 4, 13), np.int64)

    def t(i):                       # top sample A..H
        return 1 + i

    def l(i):                       # left sample I..L
        return 9 + i

    def tt(i):                      # M, A..H
        return 0 if i == 0 else t(i - 1)

    def ll(i):                      # M, I..L
        return 0 if i == 0 else l(i - 1)

    def put(m, y, x, *taps):
        for idx, wt in taps:
            w[m, y, x, idx] += wt

    for y in range(4):
        for x in range(4):
            put(I4_VERT, y, x, (t(x), 4))
            put(I4_HOR, y, x, (l(y), 4))
            if x == 3 and y == 3:
                put(I4_DDL, y, x, (t(6), 1), (t(7), 3))
            else:
                put(I4_DDL, y, x, (t(x + y), 1), (t(x + y + 1), 2),
                    (t(x + y + 2), 1))
            if x > y:
                put(I4_DDR, y, x, (tt(x - y - 1), 1), (tt(x - y), 2),
                    (tt(x - y + 1), 1))
            elif x < y:
                put(I4_DDR, y, x, (ll(y - x - 1), 1), (ll(y - x), 2),
                    (ll(y - x + 1), 1))
            else:
                put(I4_DDR, y, x, (t(0), 1), (0, 2), (l(0), 1))
            z, k = 2 * x - y, x - (y >> 1)
            if z >= 0 and z % 2 == 0:
                put(I4_VR, y, x, (tt(k), 2), (tt(k + 1), 2))
            elif z >= 0:
                put(I4_VR, y, x, (tt(k - 1), 1), (tt(k), 2), (tt(k + 1), 1))
            elif z == -1:
                put(I4_VR, y, x, (l(0), 1), (0, 2), (t(0), 1))
            else:
                put(I4_VR, y, x, (ll(y), 1), (ll(y - 1), 2), (ll(y - 2), 1))
            z, k = 2 * y - x, y - (x >> 1)
            if z >= 0 and z % 2 == 0:
                put(I4_HD, y, x, (ll(k), 2), (ll(k + 1), 2))
            elif z >= 0:
                put(I4_HD, y, x, (ll(k - 1), 1), (ll(k), 2), (ll(k + 1), 1))
            elif z == -1:
                put(I4_HD, y, x, (t(0), 1), (0, 2), (l(0), 1))
            else:
                put(I4_HD, y, x, (tt(x), 1), (tt(x - 1), 2), (tt(x - 2), 1))
            j = x + (y >> 1)
            if y % 2 == 0:
                put(I4_VL, y, x, (t(j), 2), (t(j + 1), 2))
            else:
                put(I4_VL, y, x, (t(j), 1), (t(j + 1), 2), (t(j + 2), 1))
            z, j = x + 2 * y, y + (x >> 1)
            if z > 5:
                put(I4_HU, y, x, (l(3), 4))
            elif z == 5:
                put(I4_HU, y, x, (l(2), 1), (l(3), 3))
            elif z % 2 == 0:
                put(I4_HU, y, x, (l(j), 2), (l(j + 1), 2))
            else:
                put(I4_HU, y, x, (l(j), 1), (l(j + 1), 2), (l(j + 2), 1))
    return w.reshape(9 * 16, 13)


_I4_W = _i4_weights()


def predict_i4_all(top: np.ndarray, left: np.ndarray, corner: int,
                   avail_top: bool, avail_left: bool,
                   dc: int = 128) -> np.ndarray:
    """The nine 4x4 predictions of predict_i4 at once, (9, 4, 4) int32 by
    mode, from the same edge samples (those of a mode whose neighbours
    are unavailable are computed all the same and are not to be used)."""
    e = np.empty(13, np.int64)
    e[0] = int(corner)
    e[1:9] = top
    e[9:13] = left
    p = ((_I4_W @ e + 2) >> 2).astype(np.int32).reshape(9, 4, 4)
    if avail_top and avail_left:
        p[I4_DC] = (int(e[1:5].sum()) + int(e[9:13].sum()) + 4) >> 3
    elif avail_top:
        p[I4_DC] = (int(e[1:5].sum()) + 2) >> 2
    elif avail_left:
        p[I4_DC] = (int(e[9:13].sum()) + 2) >> 2
    else:
        p[I4_DC] = dc
    return p


def predict_i8(mode: int, top: np.ndarray, left: np.ndarray, corner: int,
               avail_top: bool, avail_left: bool, avail_corner: bool,
               dc: int = 128) -> np.ndarray:
    """One 8x8 luma intra prediction (the 9 modes of the 4x4 one) after
    the reference-sample filter of spec 8.3.2.2.1. top: 16 samples (up +
    up-right; the caller substitutes top[8:] = top[7] when up-right is
    unavailable), left: 8 samples, corner: sample p[-1, -1]. Returns
    (8, 8) int32 (jm_tpu/ops/intra.py predict_i8)."""
    t = top.astype(np.int32).copy()
    l = left.astype(np.int32).copy()
    m = int(corner)
    # ---- reference sample filtering (8.3.2.2.1) ----
    if avail_top:
        ft = np.empty(16, np.int32)
        if avail_corner:
            ft[0] = (m + 2 * t[0] + t[1] + 2) >> 2
        else:
            ft[0] = (3 * t[0] + t[1] + 2) >> 2
        for x in range(1, 15):
            ft[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2
    if avail_corner:
        if avail_top and avail_left:
            fm = (t[0] + 2 * m + l[0] + 2) >> 2
        elif avail_top:
            fm = (3 * m + t[0] + 2) >> 2
        elif avail_left:
            fm = (3 * m + l[0] + 2) >> 2
        else:
            fm = m
    if avail_left:
        fl = np.empty(8, np.int32)
        if avail_corner:
            fl[0] = (m + 2 * l[0] + l[1] + 2) >> 2
        else:
            fl[0] = (3 * l[0] + l[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2
    t = ft if avail_top else t
    l = fl if avail_left else l
    m = fm if avail_corner else m

    p = np.zeros((8, 8), np.int32)
    if mode == I4_VERT:
        p[:, :] = t[:8][None, :]
    elif mode == I4_HOR:
        p[:, :] = l[:, None]
    elif mode == I4_DC:
        if avail_top and avail_left:
            p[:, :] = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif avail_top:
            p[:, :] = (int(t[:8].sum()) + 4) >> 3
        elif avail_left:
            p[:, :] = (int(l.sum()) + 4) >> 3
        else:
            p[:, :] = dc
    elif mode == I4_DDL:
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
    elif mode == I4_DDR:
        tt = np.concatenate([[m], t])
        ll = np.concatenate([[m], l])
        for y in range(8):
            for x in range(8):
                if x > y:
                    p[y, x] = (tt[x - y - 1] + 2 * tt[x - y] + tt[x - y + 1] + 2) >> 2
                elif x < y:
                    p[y, x] = (ll[y - x - 1] + 2 * ll[y - x] + ll[y - x + 1] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
    elif mode == I4_VR:
        tt = np.concatenate([[m], t])
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                k = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (tt[k] + tt[k + 1] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (tt[k - 1] + 2 * tt[k] + tt[k + 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * m + t[0] + 2) >> 2
                else:
                    ll = np.concatenate([[m], l])
                    p[y, x] = (ll[y - 2 * x] + 2 * ll[y - 2 * x - 1]
                               + ll[y - 2 * x - 2] + 2) >> 2
    elif mode == I4_HD:
        ll = np.concatenate([[m], l])
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                k = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (ll[k] + ll[k + 1] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (ll[k - 1] + 2 * ll[k] + ll[k + 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
                else:
                    tt2 = np.concatenate([[m], t])
                    p[y, x] = (tt2[x - 2 * y] + 2 * tt2[x - 2 * y - 1]
                               + tt2[x - 2 * y - 2] + 2) >> 2
    elif mode == I4_VL:
        for y in range(8):
            for x in range(8):
                k = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (t[k] + t[k + 1] + 1) >> 1
                else:
                    p[y, x] = (t[k] + 2 * t[k + 1] + t[k + 2] + 2) >> 2
    elif mode == I4_HU:
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z > 13:
                    p[y, x] = l[7]
                elif z == 13:
                    p[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                elif z % 2 == 0:
                    p[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                               + l[y + (x >> 1) + 2] + 2) >> 2
    else:
        raise ValueError(f"bad intra8x8 mode {mode}")
    return p


def predict_i16(mode: int, top: np.ndarray, left: np.ndarray, corner: int,
                avail_top: bool, avail_left: bool, dc: int = 128,
                cmax: int = 255) -> np.ndarray:
    """16x16 luma intra prediction. top/left: 16 samples each."""
    t = top.astype(np.int32)
    l = left.astype(np.int32)
    p = np.zeros((16, 16), np.int32)
    if mode == I16_VERT:
        p[:, :] = t[None, :]
    elif mode == I16_HOR:
        p[:, :] = l[:, None]
    elif mode == I16_DC:
        if avail_top and avail_left:
            p[:, :] = (int(t.sum()) + int(l.sum()) + 16) >> 5
        elif avail_top:
            p[:, :] = (int(t.sum()) + 8) >> 4
        elif avail_left:
            p[:, :] = (int(l.sum()) + 8) >> 4
        else:
            p[:, :] = dc
    elif mode == I16_PLANE:
        m = int(corner)
        tt = np.concatenate([[m], t])  # tt[i] = p[i-1, -1]
        ll = np.concatenate([[m], l])
        hh = sum((x + 1) * (int(tt[9 + x]) - int(tt[7 - x])) for x in range(8))
        vv = sum((y + 1) * (int(ll[9 + y]) - int(ll[7 - y])) for y in range(8))
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * hh + 32) >> 6
        c = (5 * vv + 32) >> 6
        ys, xs = np.mgrid[0:16, 0:16]
        p = np.clip((a + b * (xs - 7) + c * (ys - 7) + 16) >> 5, 0, cmax)
    else:
        raise ValueError(f"bad intra16 mode {mode}")
    return p


def predict_chroma(mode: int, top: np.ndarray, left: np.ndarray, corner: int,
                   avail_top: bool, avail_left: bool, dc: int = 128,
                   cmax: int = 255) -> np.ndarray:
    """Chroma intra prediction, 8x8 (4:2:0) or 8x16 (4:2:2) depending on
    len(left).  Per-4x4-block DC position rules follow
    ldecod/src/intra_chroma_pred.c:79-141 (block_pos table: 4:2:2 rows
    below the first use the bottom-left / bottom-right rules); plane mode
    uses the cr_MB_y-dependent ic scale of intra_chroma_pred.c:320-331."""
    t = top.astype(np.int32)
    l = left.astype(np.int32)
    H = len(l)
    p = np.zeros((H, 8), np.int32)
    if mode == C_DC:
        for by in range(H // 4):
            yo = by * 4
            for xo in (0, 4):
                ts = int(t[xo:xo + 4].sum())
                ls = int(l[yo:yo + 4].sum())
                # block position code: row 0 -> TL/TR, lower rows -> BL/BR
                pos = (0 if xo == 0 else 1) if by == 0 else (2 if xo == 0 else 3)
                if pos in (0, 3):
                    # "all" blocks use both edges when available
                    if avail_top and avail_left:
                        v = (ts + ls + 4) >> 3
                    elif avail_top:
                        v = (ts + 2) >> 2
                    elif avail_left:
                        v = (ls + 2) >> 2
                    else:
                        v = dc
                elif pos == 1:  # top-right block prefers top
                    if avail_top:
                        v = (ts + 2) >> 2
                    elif avail_left:
                        v = (ls + 2) >> 2
                    else:
                        v = dc
                else:  # bottom-left block prefers left
                    if avail_left:
                        v = (ls + 2) >> 2
                    elif avail_top:
                        v = (ts + 2) >> 2
                    else:
                        v = dc
                p[yo:yo + 4, xo:xo + 4] = v
    elif mode == C_HOR:
        p[:, :] = l[:, None]
    elif mode == C_VERT:
        p[:, :] = t[None, :]
    elif mode == C_PLANE:
        m = int(corner)
        h2 = H // 2
        tt = np.concatenate([[m], t])
        ll = np.concatenate([[m], l])
        hh = sum((x + 1) * (int(tt[5 + x]) - int(tt[3 - x])) for x in range(4))
        vv = sum((y + 1) * (int(ll[h2 + 1 + y]) - int(ll[h2 - 1 - y]))
                 for y in range(h2))
        a = 16 * (int(l[H - 1]) + int(t[7]))
        b = (34 * hh + 32) >> 6
        c = ((17 if H == 8 else 5) * vv + 2 * H) >> (5 if H == 8 else 6)
        ys, xs = np.mgrid[0:H, 0:8]
        p = np.clip((a + b * (xs - 3) + c * (ys - h2 + 1) + 16) >> 5, 0, cmax)
    else:
        raise ValueError(f"bad chroma mode {mode}")
    return p
