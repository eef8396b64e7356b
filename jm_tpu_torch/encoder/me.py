"""Host motion search and motion compensation of the B and P macroblock
coders (encoder/b_host.py, encoder/p_host.py): the quadrants' 4x4
blocks, the mvd bit lengths, the 4x4 Hadamard SATD, the
integer search's rate and spiral tie-break tables, its arg-min, the
half- then quarter-pel refinement, and the quarter-pel luma / eighth-pel
chroma block fetch, and the P8x8 sub-partitions. Twin of
jm_tpu/encoder/me.py (QUAD_BLKS, SUB_PARTS, SUB_MODE_BITS, mv_bits, satd,
int_rate_tab, spiral_rank_tab, best_int_mv_tiebreak, subpel_refine) and
jm_tpu/ops/interp.py (mc_luma_block, mc_chroma_block), numpy.

A reference's planes are its device reference state downloaded
(ops/enc.prep_ref: the INT, B, H, J quarter-pel planes and the padded
chroma, PAD samples of replicated border), which holds the same samples
as jm_tpu's interp.make_luma_planes / pad_plane. The integer search's SAD
tables are computed on the device (ops/enc.full_search_sad16,
full_search_sad_quad and, for the sub-8x8 search, full_search_sad_blk4).
"""

from __future__ import annotations

import numpy as np

from ..ops.consts import PAD, QPEL_TAB


# the 4x4 blocks of each 8x8 quadrant (raster in the MB)
QUAD_BLKS = np.array([[0, 1, 4, 5], [2, 3, 6, 7],
                      [8, 9, 12, 13], [10, 11, 14, 15]], np.int32)

# P8x8 sub-partitions: sub_mb_type -> [(sx, sy, sw, sh)] in 4x4 units
SUB_PARTS = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 2, 1), (0, 1, 2, 1)],
    2: [(0, 0, 1, 2), (1, 0, 1, 2)],
    3: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
}
# the rate term of each sub_mb_type in the decision, in lambdas
SUB_MODE_BITS = {0: 1, 1: 3, 2: 3, 3: 5}


def ue_len(v: int) -> int:
    return 2 * (v + 1).bit_length() - 1


def se_len(v: int) -> int:
    return ue_len(2 * v - 1 if v > 0 else -2 * v)


def mv_bits(mvd_x: int, mvd_y: int) -> int:
    return se_len(int(mvd_x)) + se_len(int(mvd_y))


_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], np.int32)


# se(v) bit length by |quarter-pel value| (the mvd rate table)
_SE_BITS_TAB = np.array(
    [1] + [2 * int(2 * a).bit_length() - 1 for a in range(1, 1 << 14)],
    np.int32)


def int_rate_tab(pred_mv, sr: int, lam: int) -> np.ndarray:
    """lambda-weighted mvd bits of every integer displacement of the
    (2 sr + 1)^2 window against a quarter-pel predictor, row-major
    (dy, dx) (lencod me_fullsearch.c:93 MV_COST)."""
    d = 4 * np.arange(-sr, sr + 1, dtype=np.int32)
    bx = _SE_BITS_TAB[np.minimum(np.abs(d - int(pred_mv[0])), (1 << 14) - 1)]
    by = _SE_BITS_TAB[np.minimum(np.abs(d - int(pred_mv[1])), (1 << 14) - 1)]
    return lam * (by[:, None] + bx[None, :]).reshape(-1)


def spiral_rank_tab(pred_mv, sr: int) -> np.ndarray:
    """Tie-break ranks of the reference's spiral order around the
    predictor (me_fullsearch.c: on equal cost the nearer candidate
    wins), row-major (side * side,), values < 2^13."""
    cx = int(np.clip(round(pred_mv[0] / 4), -sr, sr))
    cy = int(np.clip(round(pred_mv[1] / 4), -sr, sr))
    d = np.arange(-sr, sr + 1, dtype=np.int64)
    ring = np.maximum(np.abs(d[:, None] - cy), np.abs(d[None, :] - cx))
    sub = np.abs(d[:, None] - cy) + np.abs(d[None, :] - cx)
    return (ring * 64 + np.minimum(sub, 63)).reshape(-1)


def best_int_mv_tiebreak(costs: np.ndarray, rank: np.ndarray, sr: int):
    """Arg-min of (side * side,) costs with the spiral tie-break, as an
    integer MV."""
    side = 2 * sr + 1
    flat = int(np.argmin(costs.astype(np.int64) * 8192 + rank))
    return np.array([flat % side - sr, flat // side - sr], np.int32)


def mc_luma_block(planes, x4: int, y4: int, bw: int, bh: int,
                  w: int, h: int) -> np.ndarray:
    """The (bh, bw) luma prediction at quarter-pel position (x4, y4) from
    the four quarter-pel planes (4, h + 2 PAD, w + 2 PAD)."""
    xi = max(-PAD, min(w + PAD - bw - 1, x4 >> 2))
    yi = max(-PAD, min(h + PAD - bh - 1, y4 >> 2))
    p1, dx1, dy1, p2, dx2, dy2 = QPEL_TAB[(x4 & 3, y4 & 3)]
    a = planes[p1][PAD + yi + dy1:PAD + yi + dy1 + bh,
                   PAD + xi + dx1:PAD + xi + dx1 + bw].astype(np.int32)
    if p2 < 0:
        return a
    b = planes[p2][PAD + yi + dy2:PAD + yi + dy2 + bh,
                   PAD + xi + dx2:PAD + xi + dx2 + bw].astype(np.int32)
    return (a + b + 1) >> 1


def mc_chroma_block(plane: np.ndarray, x8: int, y8: int, bw: int, bh: int,
                    w: int, h: int) -> np.ndarray:
    """Eighth-pel bilinear chroma prediction (spec 8.4.2.2.2) from a
    padded chroma plane (h + 2 PAD, w + 2 PAD)."""
    xi = max(-PAD, min(w + PAD - bw - 1, x8 >> 3))
    yi = max(-PAD, min(h + PAD - bh - 1, y8 >> 3))
    xf, yf = x8 & 7, y8 & 7
    A = plane[PAD + yi:PAD + yi + bh + 1,
              PAD + xi:PAD + xi + bw + 1].astype(np.int32)
    return ((8 - xf) * (8 - yf) * A[:bh, :bw] + xf * (8 - yf) * A[:bh, 1:]
            + (8 - xf) * yf * A[1:, :bw] + xf * yf * A[1:, 1:] + 32) >> 6


def subpel_refine(orig_blk: np.ndarray, planes, px: int, py: int,
                  int_mv, w: int, h: int, pred_mv, lam: int,
                  extra_bits: int = 0, use_satd: bool = True,
                  qpel_start: bool = False):
    """Half- then quarter-pel refinement of one block around its integer
    MV (qpel_start: around a quarter-pel MV): 8 neighbours per step, the
    4x4 Hadamard SATD (use_satd; lencod me_distortion.c
    HadamardSAD4x4:175: sum |H d H^T| >> 1 over the block's 4x4 tiles;
    else the SAD) plus lam * (mvd bits + extra_bits). Returns
    (quarter-pel MV, cost). A step's 8 candidates are costed together,
    their SATDs as batched 4x4 matrix products (jm_tpu's einsum of the
    same sums is several times slower on such small tiles); a
    coefficient is at most 16 x 255, so int32 holds it exactly."""
    o = orig_blk.astype(np.int32)
    bh, bw = o.shape

    def costs(mvs):
        d = o[None] - np.stack([
            mc_luma_block(planes, px * 4 + int(m[0]), py * 4 + int(m[1]),
                          bw, bh, w, h) for m in mvs])
        if use_satd:
            t = d.reshape(len(mvs), bh // 4, 4, bw // 4, 4) \
                .transpose(0, 1, 3, 2, 4)
            dist = np.abs(_H4 @ t @ _H4.T).sum(axis=(1, 2, 3, 4)) >> 1
        else:
            dist = np.abs(d).sum(axis=(1, 2))
        return [int(dist[i]) + lam * (mv_bits(int(m[0] - pred_mv[0]),
                                             int(m[1] - pred_mv[1]))
                                     + extra_bits)
                for i, m in enumerate(mvs)]

    if qpel_start:
        best = np.asarray(int_mv, np.int32).copy()
    else:
        best = np.array([int_mv[0] * 4, int_mv[1] * 4], np.int32)
    bcost = costs([best])[0]
    for step in (2, 1):
        # the 8 neighbours at once; the first of least cost replaces the
        # centre when below it (the reference's sequential scan)
        mvs = [best + (dx, dy) for dy in (-step, 0, step)
               for dx in (-step, 0, step) if dx or dy]
        c = costs(mvs)
        i = min(range(8), key=c.__getitem__)
        if c[i] < bcost:
            best, bcost = mvs[i], c[i]
    return best, bcost
