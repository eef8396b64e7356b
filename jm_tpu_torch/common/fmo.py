"""FMO (flexible macroblock ordering) slice-group maps, spec 8.2.2; the
port's copy of jm_tpu/common/fmo.py.

Capability parity with lencod/src/fmo.c (FmoInit:209, generators
FmoGenerateType0..6MapUnitMap:58-64, FmoGetNextMBNr) and the decoder twin
ldecod/src/fmo.c: the whole map and the per-group successor array are
computed once per picture, in place of the reference's per-MB
FmoGetNextMBNr walk.

Map units are macroblocks here (frame_mbs_only streams).
"""

from __future__ import annotations

import numpy as np


def mb_to_slice_group_map(pps, sps, slice_group_change_cycle: int = 0
                          ) -> np.ndarray:
    """Return int32 array of slice-group ids per MB address."""
    W = sps.pic_width_in_mbs
    H = sps.frame_height_in_mbs
    n = W * H
    num_groups = pps.num_slice_groups_minus1 + 1
    if num_groups == 1:
        return np.zeros(n, np.int32)
    t = pps.slice_group_map_type
    if t == 0:
        return _type0_interleave(pps.run_length_minus1, n, num_groups)
    if t == 1:
        return _type1_dispersed(W, n, num_groups)
    if t == 2:
        return _type2_foreground(pps.top_left, pps.bottom_right, W, n,
                                 num_groups)
    if t in (3, 4, 5):
        g0 = min((slice_group_change_cycle
                  * (pps.slice_group_change_rate_minus1 + 1)), n)
        d = pps.slice_group_change_direction_flag
        if t == 3:
            return _type3_boxout(W, H, g0, d)
        if t == 4:
            return _type4_raster(n, g0, d)
        return _type5_wipe(W, H, g0, d)
    if t == 6:
        m = np.asarray(pps.slice_group_id, np.int32)
        if m.size != n:
            raise ValueError("explicit slice_group_id size mismatch")
        return m
    raise ValueError(f"slice_group_map_type {t}")


def _type0_interleave(run_length_minus1, n, num_groups) -> np.ndarray:
    runs = [r + 1 for r in run_length_minus1[:num_groups]]
    out = np.empty(n, np.int32)
    i = 0
    while i < n:
        for g, r in enumerate(runs):
            take = min(r, n - i)
            out[i:i + take] = g
            i += take
            if i >= n:
                break
    return out


def _type1_dispersed(W, n, num_groups) -> np.ndarray:
    i = np.arange(n)
    return (((i % W) + (((i // W) * num_groups) // 2)) % num_groups) \
        .astype(np.int32)


def _type2_foreground(top_left, bottom_right, W, n, num_groups) -> np.ndarray:
    out = np.full(n, num_groups - 1, np.int32)
    # higher-indexed rectangles first so lower group indices win (spec:
    # "for( iGroup = num_slice_groups_minus1 - 1; iGroup >= 0; iGroup-- )")
    for g in range(num_groups - 2, -1, -1):
        tl, br = top_left[g], bottom_right[g]
        y0, x0 = tl // W, tl % W
        y1, x1 = br // W, br % W
        for y in range(y0, min(y1, n // W - 1) + 1):
            for x in range(x0, min(x1, W - 1) + 1):
                out[y * W + x] = g
    return out


def _type3_boxout(W, H, g0, d) -> np.ndarray:
    out = np.ones(W * H, np.int32)
    x = (W - d) // 2
    y = (H - d) // 2
    left = right = x
    top = bottom = y
    xdir, ydir = d - 1, d
    k = 0
    while k < g0:
        vacant = out[y * W + x] == 1
        if vacant:
            out[y * W + x] = 0
            k += 1
        if xdir == -1 and x == left:
            left = max(left - 1, 0)
            x = left
            xdir, ydir = 0, 2 * d - 1
        elif xdir == 1 and x == right:
            right = min(right + 1, W - 1)
            x = right
            xdir, ydir = 0, 1 - 2 * d
        elif ydir == -1 and y == top:
            top = max(top - 1, 0)
            y = top
            xdir, ydir = 1 - 2 * d, 0
        elif ydir == 1 and y == bottom:
            bottom = min(bottom + 1, H - 1)
            y = bottom
            xdir, ydir = 2 * d - 1, 0
        else:
            x += xdir
            y += ydir
    return out


def _type4_raster(n, g0, d) -> np.ndarray:
    size_ul = (n - g0) if d else g0
    i = np.arange(n)
    return np.where(i < size_ul, d, 1 - d).astype(np.int32)


def _type5_wipe(W, H, g0, d) -> np.ndarray:
    out = np.empty(W * H, np.int32)
    k = 0
    cols = range(W) if d == 0 else range(W - 1, -1, -1)
    rows = list(range(H)) if d == 0 else list(range(H - 1, -1, -1))
    for j in cols:
        for i in rows:
            out[i * W + j] = 0 if k < g0 else 1
            k += 1
    return out


def next_mb_arrays(group_map: np.ndarray) -> np.ndarray:
    """succ[addr] = next MB address in the same slice group (raster order),
    or n when the group is exhausted — the vectorized FmoGetNextMBNr."""
    n = group_map.size
    succ = np.full(n, n, np.int32)
    last: dict[int, int] = {}
    for addr in range(n - 1, -1, -1):
        g = int(group_map[addr])
        if g in last:
            succ[addr] = last[g]
        last[g] = addr
    return succ
