"""Rate-distortion optimized quantization, the trellis of lencod's
UseRDOQuant (VCEG-AH21), twin of jm_tpu/encoder/rdoq.py (lencod rdoq.c
trellis_coding, init_trellis_data_*; rdoq_cabac.c estRunLevel_CABAC,
est_writeRunLevel_CABAC; rdoq_cavlc.c est_RunLevel_CAVLC). Per
transformed block, each coefficient gets up to three candidate levels
{0, floor(w/step), floor+1}; the search picks the levels of least
D + lambda R, D the transform-domain SSD scaled to the pixel domain by
the inverse-basis norms, R the entropy coder's rate:

- CAVLC: the exact bits of the block writer
  (cavlc_write.residual_block_bits), a greedy pass over the
  coefficients in decreasing magnitude;
- CABAC: bits estimated from the slice's live context states through
  the expected-bits table (ENTROPY_BITS), the last position first, then
  each coefficient's level.

ENTROPY_BITS is -log2(p) 2^15 over the CABAC state probabilities, and
the estErr scales are the dequant scales squared times the inverse
transform's basis norms (lencod/inc/rdoq.h estErr4x4 / estErr8x8).
"""

from __future__ import annotations

import math

import numpy as np

from ..common.tables import (DEQUANT_SCALE_4x4, DEQUANT_SCALE_8x8,
                             QUANT_SCALE_4x4, QUANT_SCALE_8x8, ZIGZAG_4x4,
                             ZIGZAG_8x8)
from ..decoder.cabac import (MAX_C2, MAXPOS, TYPE2CTX_ABS, TYPE2CTX_BCBP,
                             TYPE2CTX_LAST, TYPE2CTX_MAP, TYPE2CTX_ONE,
                             pos2ctx_last, pos2ctx_map)
from .cavlc_write import residual_block_bits

# ---------------------------------------------------------------------------
# derived tables


def _entropy_bits() -> np.ndarray:
    """Expected bits (in 1/2^15 units) of coding a bin at each of the 128
    arithmetic-coder context states: index 64+s = LPS at state s, 63-s =
    MPS at state s. p_LPS(s) = 0.5 * alpha^s with alpha chosen so
    p(63) = 0.01875 (the CABAC probability model the state-transition
    tables quantize)."""
    alpha = (0.01875 / 0.5) ** (1.0 / 63)
    t = np.zeros(128, np.int64)
    for s in range(64):
        p = 0.5 * alpha ** s
        t[64 + s] = round(-math.log2(p) * 32768)      # coding the LPS
        t[63 - s] = round(-math.log2(1.0 - p) * 32768)  # coding the MPS
    return t


ENTROPY_BITS = _entropy_bits()

# pixel-domain distortion scale per coefficient position: squared inverse
# basis norms of the 4x4 / 8x8 inverse transforms (x16 DQ scaling); the
# products V^2 * B[j] * B[i] equal lencod/inc/rdoq.h estErr4x4/estErr8x8
_B4 = np.array([16.0, 10.0, 16.0, 10.0])
_C8 = np.array([128.0, 144.5, 80.0, 144.5, 128.0, 144.5, 80.0, 144.5])

ESTERR_4x4 = (DEQUANT_SCALE_4x4.astype(np.float64) ** 2
              * _B4[None, :, None] * _B4[None, None, :])   # (6, 4, 4)
ESTERR_8x8 = (DEQUANT_SCALE_8x8.astype(np.float64) ** 2
              * _C8[None, :, None] * _C8[None, None, :])   # (6, 8, 8)

NORM_4x4 = float(1 << 31)     # 2^(2*DQ_BITS+19), rdoq.c init_rdoq_slice
NORM_8x8 = float(1 << 41)     # 2^(2*Q_BITS_8+9)

_ZZ4 = np.asarray(ZIGZAG_4x4)
_ZZ8 = np.asarray(ZIGZAG_8x8)
# estErr / MF in 4x4 zig-zag scan order, per qp_rem
_ESTERR4_SCAN = ESTERR_4x4.reshape(6, 16)[:, _ZZ4] / NORM_4x4
_MF4_SCAN = QUANT_SCALE_4x4.reshape(6, 16)[:, _ZZ4].astype(np.int64)
_ESTERR8_SCAN = ESTERR_8x8.reshape(6, 64)[:, _ZZ8] / NORM_8x8
_MF8_SCAN = QUANT_SCALE_8x8.reshape(6, 64)[:, _ZZ8].astype(np.int64)


class LevelData:
    """Per-coefficient candidate levels (rdoq.c levelDataStruct)."""
    __slots__ = ("levels", "errs", "nlev", "pre_level", "sign",
                 "level_double")

    def __init__(self):
        self.levels = [0, 0, 0]
        self.errs = [0.0, 0.0, 0.0]
        self.nlev = 1
        self.pre_level = 0
        self.sign = 0
        self.level_double = 0


def build_level_data(w_scan, mf_scan, q_bits: int, offset: int,
                     esterr_scan):
    """Candidate levels/errors for one block (init_trellis_data_* twin).

    w_scan: transform coefficients in scan order (signed int);
    mf_scan: forward quant scale per scan position; offset: deadzone
    offset in the same q_bits scale (pre_level rounding only);
    esterr_scan: distortion scale per position (already / norm).
    Returns (list[LevelData], kStart, kStop, noCoeff)."""
    n = len(w_scan)
    data = []
    k_start = k_stop = 0
    no_coeff = 0
    half = 1 << (q_bits - 1)
    for k in range(n):
        d = LevelData()
        w = int(w_scan[k])
        if w != 0:
            scaled = abs(w) * int(mf_scan[k])
            d.level_double = scaled
            level = scaled >> q_bits
            lower = (scaled - (level << q_bits)) < half
            if level == 0 and lower:
                d.nlev = 1
            elif level == 0:
                d.levels[1] = 1
                d.nlev = 2
                k_stop = k
                no_coeff += 1
            elif lower:
                d.levels[1] = level
                d.nlev = 2
                k_stop = k
                no_coeff += 1
            else:
                d.levels[1] = level
                d.levels[2] = level + 1
                d.nlev = 3
                k_stop = k
                k_start = k
                no_coeff += 1
            ee = float(esterr_scan[k])
            for i in range(d.nlev):
                err = float(d.levels[i] << q_bits) - float(scaled)
                d.errs[i] = err * err * ee
            d.pre_level = (scaled + offset) >> q_bits
            d.sign = 1 if w > 0 else -1
        data.append(d)
    return data, k_start, k_stop, no_coeff


# ---------------------------------------------------------------------------
# CAVLC search (rdoq_cavlc.c est_RunLevel_CAVLC:372)


def rdoq_cavlc_block(data, lam: float, nc: int, max_coeff: int):
    """Greedy coordinate descent with exact CAVLC bits
    (cavlc_write.residual_block_bits, the length write_residual_block
    writes). Returns signed levels in scan order (len(data),) int32."""
    n = len(data)
    levels = [0] * n
    last_nz = -1
    order = []
    for k, d in enumerate(data):
        for i in range(d.nlev):
            d.errs[i] /= 32768.0
        levels[k] = d.pre_level * d.sign
        if d.nlev > 1:
            last_nz = k
            order.append(k)
    if last_nz < 0:
        return np.zeros(n, np.int32)
    # visit coefficients in decreasing |value| (the qsort in JM)
    order.sort(key=lambda k: data[k].level_double, reverse=True)
    for k in order:
        d = data[k]
        best_i, best_j = 0, None
        for i in range(d.nlev):
            levels[k] = d.levels[i] * d.sign
            j = d.errs[i] + lam * residual_block_bits(levels, nc, max_coeff)
            if best_j is None or j < best_j:
                best_j, best_i = j, i
        levels[k] = d.levels[best_i] * d.sign
    return np.array(levels, np.int32)


# ---------------------------------------------------------------------------
# CABAC search (rdoq_cabac.c est_writeRunLevel_CABAC:440)

# JM prices the sign bypass bin at 1/2^15 bit (rdoq.h SIGN_BITS=1 against
# the 2^15-scaled estimate tables) — i.e. essentially free. Matching that
# tuning matters: charging the true 1 bit per kept coefficient makes the
# trellis zero far more aggressively than JM and loses PSNR.
_SIGN_BITS = 1


def _ctx_state(ctx_row) -> int:
    """context (state, mps) -> JM's 0..127 combined state for the
    expected-bits table (64+state if next bin were the MPS side)."""
    return int(ctx_row[0]), int(ctx_row[1])


def _bin_bits(ctx_row, binval: int) -> int:
    state, mps = int(ctx_row[0]), int(ctx_row[1])
    cs = (64 + state) if binval == mps else (63 - state)
    return int(ENTROPY_BITS[127 - cs])


def _unary_exp_golomb_bits(symbol: int, bits0: int, bits1: int) -> int:
    """Estimated bits of the UEG0 level suffix (value - 2) coded with a
    truncated-unary prefix (13 bins max) + EG0 bypass escape."""
    if symbol == 0:
        return bits0
    exp_start = 13
    bits = bits1
    lv, k = symbol, 1
    while lv - 1 > 0 and k + 1 <= exp_start:
        lv -= 1
        k += 1
        bits += bits1
    if symbol < exp_start:
        bits += bits0
    else:
        # exp-golomb eq-prob bits on (symbol - exp_start)
        s = symbol - exp_start
        kk, eb = 0, 0
        while s >= (1 << kk):
            eb += 1
            s -= 1 << kk
            kk += 1
        bits += eb + kk + 1
    return bits


class CabacBlockBits:
    """Per-block-type estimated bin costs from live context states
    (rdoq_cabac.c estRunLevel_CABAC:286)."""

    def __init__(self, ctxs, block_type: int):
        maxk = MAXPOS[block_type]
        p2m = pos2ctx_map(block_type)
        p2l = pos2ctx_last(block_type)
        map_ctx = ctxs.map[TYPE2CTX_MAP[block_type]]
        last_ctx = ctxs.last[TYPE2CTX_LAST[block_type]]
        one_ctx = ctxs.one[TYPE2CTX_ONE[block_type]]
        abs_ctx = ctxs.abs[TYPE2CTX_ABS[block_type]]
        self.maxpos = maxk
        self.sig = np.zeros((16, 2), np.int64)
        self.last = np.zeros((16, 2), np.int64)
        for k in range(maxk):
            cm, cl = int(p2m[k]), int(p2l[k])
            self.sig[cm, 0] = _bin_bits(map_ctx[cm], 0)
            self.sig[cm, 1] = _bin_bits(map_ctx[cm], 1)
            self.last[cl, 0] = _bin_bits(last_ctx[cl], 0)
            self.last[cl, 1] = _bin_bits(last_ctx[cl], 1)
        # the final scan position's significance is implied (spec 9.3.2.3
        # inference) — its ctx slot gets zero cost
        self.sig[int(p2m[maxk])] = 0
        self.last[int(p2l[maxk])] = 0
        self.p2m, self.p2l = p2m, p2l
        self.gt1 = np.zeros((5, 2), np.int64)     # one_contexts ctx 0..4
        for c in range(5):
            self.gt1[c, 0] = _bin_bits(one_ctx[c], 0)
            self.gt1[c, 1] = _bin_bits(one_ctx[c], 1)
        mc2 = min(4, MAX_C2[block_type])
        self.abs0 = np.zeros(5, np.int64)
        self.abs1 = np.zeros(5, np.int64)
        for c in range(mc2 + 1):
            self.abs0[c] = _bin_bits(abs_ctx[c], 0)
            self.abs1[c] = _bin_bits(abs_ctx[c], 1)
        self.max_c2 = MAX_C2[block_type]


def rdoq_cabac_block(data, k_start, k_stop, no_coeff, lam: float,
                     bb: CabacBlockBits, est_cbp: int):
    """JM est_writeRunLevel_CABAC: pick the last significant position,
    then per-coefficient levels against context-estimated bits; compare
    the whole result against the all-zero block (whose rate saving is
    est_cbp, the cbf-bit cost difference). Returns |levels| in scan
    order."""
    n = len(data)
    out = np.zeros(n, np.int32)
    if no_coeff == 0:
        return out
    # distortions here are 2^15 times the CAVLC-path units and the bit
    # estimates are in 1/2^15-bit units, so lambda applies unscaled (the
    # whole Lagrangian is JM's, multiplied through by 2^15)
    if no_coeff > 1:
        k_s = k_start
        k_best, first = 0, 1
        lagr_acc = 0.0
        for k in range(k_s, k_stop + 1):
            lagr_acc += data[k].errs[0]
        lagr_last_min = 0.0
        if data[k_s].nlev > 2:
            lb = bb.last[int(bb.p2l[k_s])]
            lagr_acc -= data[k_s].errs[0]
            lagr_last_min = lam * (int(lb[1]) - int(lb[0])) + lagr_acc
            k_best = k_s
            k_s += 1
            first = 0
        lagr_min = 0.0
        for k in range(k_s, k_stop + 1):
            d = data[k]
            sig = bb.sig[int(bb.p2m[k])]
            lagr_min = d.errs[0] + lam * int(sig[0])
            lagr_acc -= d.errs[0]
            if d.nlev > 1:
                lb = bb.last[int(bb.p2l[k])]
                est = _SIGN_BITS + int(sig[1]) + int(bb.gt1[4, 0])
                lagr = d.errs[1] + lam * est
                lagr_last = lagr + lam * int(lb[1]) + lagr_acc
                lagr = lagr + lam * int(lb[0])
                lagr_min = min(lagr, lagr_min)
                if lagr_last < lagr_last_min or first == 1:
                    k_best = k
                    first = 0
                    lagr_last_min = lagr_last
            lagr_acc += lagr_min
        k_start = k_best
    else:
        k_start = k_stop

    # all-zero alternative
    lagr_tab_min = sum(data[k].errs[0] for k in range(k_start + 1))
    lagr_tab_min += lam * est_cbp
    lagr_tab = 0.0
    level_tab = [0] * (k_start + 1)
    c1, c2 = 1, 0
    first = 1
    i_best = 0
    lagr_min = 0.0
    for k in range(k_start, -1, -1):
        d = data[k]
        sig = bb.sig[int(bb.p2m[k])]
        lb = bb.last[int(bb.p2l[k])]
        last = 1 if k == k_start else 0
        if not last:
            lagr_min = d.errs[0] + lam * int(sig[0])
            i_best = 0
            first = 0
        c1_tab = [c1, c1, c1]
        c2_tab = [c2, c2, c2]
        for i in range(1, d.nlev):
            est = _SIGN_BITS + int(sig[1]) + int(lb[last])
            greater_one = 1 if d.levels[i] > 1 else 0
            ctx = min(c1_tab[i], 4)
            est += int(bb.gt1[ctx, greater_one])
            if greater_one:
                ctx = min(c2_tab[i], bb.max_c2)
                est += _unary_exp_golomb_bits(
                    d.levels[i] - 2, int(bb.abs0[ctx]), int(bb.abs1[ctx]))
                c1_tab[i] = 0
                c2_tab[i] += 1
            elif c1_tab[i]:
                c1_tab[i] += 1
            lagr = d.errs[i] + lam * est
            if first == 1 or lagr < lagr_min:
                i_best = i
                lagr_min = lagr
                first = 0
        if i_best > 0:
            c1, c2 = c1_tab[i_best], c2_tab[i_best]
        level_tab[k] = d.levels[i_best]
        lagr_tab += lagr_min
    if lagr_tab < lagr_tab_min:
        for k in range(k_start + 1):
            out[k] = level_tab[k]
    return out


def est_cbp_bit(ctxs, block_type: int, ctx: int) -> int:
    """bits(cbf=0) - bits(cbf=1) for the given neighbor context, in
    1/2^15 units (rdoq_cabac.c est_write_and_store_CBP_block_bit)."""
    row = ctxs.bcbp[TYPE2CTX_BCBP[block_type]]
    return _bin_bits(row[ctx], 0) - _bin_bits(row[ctx], 1)


# ---------------------------------------------------------------------------
# block-level entry points used by the frame encoder


def trellis_4x4(w_scan, qp: int, intra: bool, lam: float, *,
                entropy: str, block_type: int, nc: int = 0,
                max_coeff: int = 16, ctxs=None, cbf_ctx: int = 0,
                dc: bool = False, start: int = 0):
    """Trellis-quantize one 4x4-transform block given in scan order.

    w_scan: scan-order transform coefficients (for AC blocks, positions
    start..15 of the zig-zag; pass start=1 so the distortion scales
    line up). dc=True: Hadamard DC block (flat scale, q_bits+1).
    Returns signed levels, same length as w_scan."""
    rem, per = qp % 6, qp // 6
    if dc:
        q_bits = 15 + per + 1
        mf = np.full(len(w_scan), int(QUANT_SCALE_4x4[rem, 0, 0]), np.int64)
        ee = np.full(len(w_scan), float(_ESTERR4_SCAN[rem][0]))
        offset = ((1 << q_bits) // (3 if intra else 6))
    else:
        q_bits = 15 + per
        mf = _MF4_SCAN[rem][start:start + len(w_scan)]
        ee = _ESTERR4_SCAN[rem][start:start + len(w_scan)]
        offset = (1 << q_bits) // (3 if intra else 6)
    data, k_start, k_stop, no_coeff = build_level_data(
        w_scan, mf, q_bits, offset, ee)
    if entropy == "cavlc":
        return rdoq_cavlc_block(data, lam, nc, max_coeff)
    bb = CabacBlockBits(ctxs, block_type)
    est = est_cbp_bit(ctxs, block_type, cbf_ctx)
    out = rdoq_cabac_block(data, k_start, k_stop, no_coeff, lam, bb, est)
    for k, d in enumerate(data):
        out[k] *= d.sign
    return out


def trellis_8x8(w_scan, qp: int, intra: bool, lam: float, *,
                ctxs, cbf_ctx: int = 0):
    """Trellis-quantize one 8x8 block (CABAC only; block_type LUMA_8x8=2).
    w_scan: 64 scan-order coefficients. Returns signed levels (64,)."""
    rem, per = qp % 6, qp // 6
    q_bits = 16 + per
    mf = _MF8_SCAN[rem]
    ee = _ESTERR8_SCAN[rem]
    offset = (1 << q_bits) // (3 if intra else 6)
    data, k_start, k_stop, no_coeff = build_level_data(
        w_scan, mf, q_bits, offset, ee)
    bb = CabacBlockBits(ctxs, 2)
    est = est_cbp_bit(ctxs, 2, cbf_ctx)
    out = rdoq_cabac_block(data, k_start, k_stop, no_coeff, lam, bb, est)
    for k, d in enumerate(data):
        out[k] *= d.sign
    return out
