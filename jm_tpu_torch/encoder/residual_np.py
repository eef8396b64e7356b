"""Numpy residual coding of single macroblocks for the host coders
(encoder/p_intra.py, intra_host.py, b_host.py, p_host.py): the forward
4x4 and 8x8 transforms, flat quant, the 4x4 scans (the zig-zag of frame
pictures by default, or the caller's ``scan``: the field scan of field
pictures) and the 8x8 zig-zag, the decode-mirror recon of 4x4, 8x8 and Intra16x16 luma and of 4:2:0 and
4:2:2 chroma (flat, or with a scaling matrix's inverse table ``tab``;
the 4:2:2 chroma DC is a 2x4 Hadamard quantized at QPc + 3), and JM's
run-weighted coefficient costs, and the SP pictures' level decision and
requantizing recon (sp_*). A trimmed copy of
jm_tpu/encoder/residual_np.py, whose module-global scan switch is an
argument here; the inverse halves are the
port's decoder's (decoder/recon.py), so the encoder's recon is what a
decoder reconstructs.
"""

from __future__ import annotations

import numpy as np

from .. import native as N
from ..common.tables import (DEQUANT_SCALE_4x4, DEQUANT_SCALE_8x8,
                             QUANT_SCALE_4x4, QUANT_SCALE_8x8, SCAN_YUV422,
                             ZIGZAG_4x4, ZIGZAG_8x8)
from ..decoder.recon import (_np_hadamard4, _np_ihadamard2x4, _np_inv4,
                             _np_inv8, _rshift_rnd_sf)
from ..ops.quant import FLAT_INV_SCALE_4x4
from ..ops.transform import fwd8_1d

_ZZ = np.asarray(ZIGZAG_4x4)
_ZZ8 = np.asarray(ZIGZAG_8x8)
FLAT_INV_SCALE_8x8 = (DEQUANT_SCALE_8x8[np.arange(52) % 6] * 16) \
    .astype(np.int32)

# JM coefficient thresholding (lencod block.c COEFF_COST4x4:72; the chroma
# AC of a component is dropped below CHROMA_COEFF_COST, block.c:1141)
COEFF_COST4 = np.array([3, 2, 2, 1, 1, 1] + [0] * 10, np.int64)
COEFF_COST8 = np.array([3] * 4 + [2] * 8 + [1] * 12 + [0] * 40, np.int64)
COST_BIG = 1 << 20       # stands in for JM's MAX_VALUE (any |level| > 1)
LUMA_COEFF_COST = 4      # per inter 8x8 quadrant (macroblock.c:901)
LUMA_MB_COEFF_COST = 5   # per inter MB (macroblock.c:1248)
CHROMA_COEFF_COST = 4


def np_forward4x4(x: np.ndarray) -> np.ndarray:
    """Batched forward core transform, (..., 4, 4) int."""
    d = x.astype(np.int64)
    p0 = d[..., 0, :] + d[..., 3, :]
    p1 = d[..., 1, :] + d[..., 2, :]
    m0 = d[..., 0, :] - d[..., 3, :]
    m1 = d[..., 1, :] - d[..., 2, :]
    t = np.stack([p0 + p1, 2 * m0 + m1, p0 - p1, m0 - 2 * m1], axis=-2)
    p0 = t[..., :, 0] + t[..., :, 3]
    p1 = t[..., :, 1] + t[..., :, 2]
    m0 = t[..., :, 0] - t[..., :, 3]
    m1 = t[..., :, 1] - t[..., :, 2]
    return np.stack([p0 + p1, 2 * m0 + m1, p0 - p1, m0 - 2 * m1], axis=-1)


def np_hadamard2x2(x: np.ndarray) -> np.ndarray:
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    r0 = np.stack([a + b + c + d, a - b + c - d], axis=-1)
    r1 = np.stack([a + b - c - d, a - b - c + d], axis=-1)
    return np.stack([r0, r1], axis=-2)


def np_quant_4x4(w: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    mf = QUANT_SCALE_4x4[qp % 6].astype(np.int64)
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    lev = (np.abs(w.astype(np.int64)) * mf + f) >> qbits
    return (np.sign(w) * lev).astype(np.int32)


def np_quant_dc(dc: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """DC quant after the forward Hadamard (luma 4x4 or chroma 2x2)."""
    mf = int(QUANT_SCALE_4x4[qp % 6, 0, 0])
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    lev = (np.abs(dc.astype(np.int64)) * mf + 2 * f) >> (qbits + 1)
    return (np.sign(dc) * lev).astype(np.int32)


def np_forward8x8(x: np.ndarray) -> np.ndarray:
    """Batched forward 8x8 transform, (..., 8, 8) int (lencod
    transform8x8.c forward8x8)."""
    d = x.astype(np.int64)
    t = np.stack(fwd8_1d(tuple(d[..., j, :] for j in range(8))), axis=-2)
    return np.stack(fwd8_1d(tuple(t[..., :, i] for i in range(8))), axis=-1)


def np_quant_8x8(w: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """Flat 8x8 quant (lencod quant8x8_normal.c: qbits 16 + qp / 6)."""
    mf = QUANT_SCALE_8x8[qp % 6].astype(np.int64)
    qbits = 16 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    lev = (np.abs(w.astype(np.int64)) * mf + f) >> qbits
    return (np.sign(w) * lev).astype(np.int32)


def to_scan8(raster: np.ndarray) -> np.ndarray:
    """(..., 8, 8) raster -> (..., 64) 8x8 zig-zag order."""
    return raster.reshape(*raster.shape[:-2], 64)[..., _ZZ8]


def recon_luma_8x8(pred_q, lev_scan, qp: int, tab=None):
    """Decode-mirror 8x8 recon: pred_q (..., 8, 8) + lev_scan (..., 64)
    8x8 zig-zag levels; tab: the (52, 8, 8) LevelScale8 (flat by
    default)."""
    r = np.zeros((*lev_scan.shape[:-1], 64), np.int64)
    r[..., _ZZ8] = lev_scan
    r = r.reshape(*lev_scan.shape[:-1], 8, 8)
    scale = (FLAT_INV_SCALE_8x8 if tab is None else tab)[qp].astype(np.int64)
    deq = _rshift_rnd_sf((r * scale) << (qp // 6), 6)
    return np.clip(pred_q + ((_np_inv8(deq) + 32) >> 6), 0, 255) \
        .astype(np.uint8)


def to_scan(raster_blocks: np.ndarray, scan=_ZZ) -> np.ndarray:
    """(..., 4, 4) raster -> (..., 16) in the order of scan (16 raster
    positions; the zig-zag by default)."""
    return raster_blocks.reshape(*raster_blocks.shape[:-2], 16)[..., scan]


def from_scan(levels: np.ndarray, scan=_ZZ) -> np.ndarray:
    """(..., 16) in the order of scan -> (..., 4, 4) raster."""
    out = np.zeros_like(levels)
    out[..., scan] = levels
    return out.reshape(*levels.shape[:-1], 4, 4)


def _dequant_4x4(coef, qp: int, tab=None):
    scale = (FLAT_INV_SCALE_4x4 if tab is None else tab)[qp]
    return _rshift_rnd_sf((coef.astype(np.int64) * scale) << (qp // 6),
                          4).astype(np.int32)


def recon_luma_4x4(pred_blocks, lev_scan, qp: int, tab=None, scan=_ZZ):
    """Decode-mirror recon of 4x4 luma blocks that are not Intra16x16:
    pred_blocks (k, 4, 4), lev_scan (k, 16) levels in the order of scan;
    tab: the (52, 4, 4) InvLevelScale (flat by default), as for every
    recon here."""
    r = (_np_inv4(_dequant_4x4(from_scan(lev_scan, scan), qp, tab))
         + 32) >> 6
    return np.clip(pred_blocks + r, 0, 255).astype(np.uint8)


def recon_luma_i16(pred_blocks, ac_scan, dc_scan, qp: int, tab=None,
                   scan=_ZZ):
    """Decode-mirror Intra16x16 recon: pred_blocks (16, 4, 4), ac_scan
    (16, 16) with [:, 0] == 0, dc_scan (16,) DC levels, both in the order
    of scan."""
    d = _dequant_4x4(from_scan(ac_scan, scan), qp, tab)
    dc_t = _np_hadamard4(from_scan(dc_scan, scan))
    scale = int((FLAT_INV_SCALE_4x4 if tab is None else tab)[qp, 0, 0])
    dc_s = _rshift_rnd_sf((dc_t.astype(np.int64) * scale) << (qp // 6), 6)
    blk = np.arange(16)
    d[blk, 0, 0] = dc_s[blk // 4, blk % 4]
    r = (_np_inv4(d) + 32) >> 6
    return np.clip(pred_blocks + r, 0, 255).astype(np.uint8)


def recon_chroma(pred_blocks, ac_scan, dc_lev, qp_c: int, tab=None,
                 scan=_ZZ):
    """Decode-mirror chroma recon of one component: pred_blocks (4, 4, 4),
    ac_scan (4, 16) with [:, 0] == 0 in the order of scan, dc_lev (4,)
    raster DC levels."""
    d = _dequant_4x4(from_scan(ac_scan, scan), qp_c, tab)
    f = np_hadamard2x2(dc_lev.reshape(2, 2).astype(np.int64))
    scale = int((FLAT_INV_SCALE_4x4 if tab is None else tab)[qp_c, 0, 0])
    dc_s = ((f * scale) << (qp_c // 6)) >> 5
    blk = np.arange(4)
    d[blk, 0, 0] = dc_s[blk // 2, blk % 2]
    r = (_np_inv4(d) + 32) >> 6
    return np.clip(pred_blocks + r, 0, 255).astype(np.uint8)


def np_hadamard4x2(dc_cols: np.ndarray) -> np.ndarray:
    """Forward 4:2:2 chroma DC Hadamard (lcommon/src/transform.c
    hadamard4x2:220) of (2, 4) DCs in the [column i][row j] layout."""
    d = dc_cols.astype(np.int64)
    tmp = np.stack([d[0] + d[1], d[0] - d[1]])          # (2, 4)
    p0, p1, p2, p3 = tmp[:, 0], tmp[:, 1], tmp[:, 2], tmp[:, 3]
    t0, t1 = p0 + p3, p1 + p2
    t2, t3 = p1 - p2, p0 - p3
    return np.stack([t0 + t1, t3 + t2, t0 - t1, t3 - t2], axis=-1)


def quant_dc422(dc_raster: np.ndarray, qp_c: int, intra: bool,
                qfn=None) -> np.ndarray:
    """The 8 chroma DC levels in SCAN_YUV422 order of one 8x16 component
    from its blocks' raster DCs (8,) (lencod block.c:1056-1076: the 2x4
    Hadamard, then the DC quant at QPc + 3); qfn: the QuantCtx DC
    quantizer of a scaling matrix, else np_quant_dc."""
    cols = np.stack([dc_raster[0::2], dc_raster[1::2]])   # [col i][row j]
    lev = (qfn or np_quant_dc)(np_hadamard4x2(cols), qp_c + 3, intra)
    return np.array([lev[i, j] for (i, j) in SCAN_YUV422], np.int32)


def recon_chroma422(pred_blocks, ac_scan, dc_scan, qp_c: int, tab=None,
                    scan=_ZZ):
    """Decode-mirror 4:2:2 chroma recon of one component: pred_blocks
    (8, 4, 4) raster blocks (2 wide, 4 tall), ac_scan (8, 16) with
    [:, 0] == 0 in the order of scan, dc_scan (8,) DC levels in
    SCAN_YUV422 order."""
    t = FLAT_INV_SCALE_4x4 if tab is None else tab
    d = _dequant_4x4(from_scan(ac_scan, scan), qp_c, tab)
    f = _np_ihadamard2x4(dc_scan)                       # (2 cols, 4 rows)
    qpdc = qp_c + 3
    dc_s = _rshift_rnd_sf((f * int(t[qpdc, 0, 0])) << (qpdc // 6), 6)
    for j in range(4):
        for i in range(2):
            d[2 * j + i, 0, 0] = dc_s[i, j]
    r = (_np_inv4(d) + 32) >> 6
    return np.clip(pred_blocks + r, 0, 255).astype(np.uint8)


def coeff_cost_scan(scan, tab=COEFF_COST4, start: int = 0) -> int:
    """Run-weighted coefficient cost of one scan array (tab: COEFF_COST4,
    or COEFF_COST8 for an 8x8 block)."""
    cost, run = 0, 0
    for k in range(start, len(scan)):
        v = int(scan[k])
        if v == 0:
            run += 1
        else:
            cost += COST_BIG if abs(v) > 1 else int(tab[run])
            run = 0
    return cost


# ---------------------------------------------------------------------------
# SP switching pictures (jm_tpu/encoder/residual_np.py:262-501): the levels
# quantize the difference between the transformed source and a quantize-
# dequantize estimate of the transformed prediction (lencod block.c
# residual_transform_quant_luma_4x4_sp:1518, ..._chroma_4x4_sp:1700); the
# recon requantizes prediction + dequantized level at the switching QP QS,
# as the decoder does (ops/dec.sp_recon).
# ---------------------------------------------------------------------------

SP_A = np.array([[16, 20, 16, 20], [20, 25, 20, 25],
                 [16, 20, 16, 20], [20, 25, 20, 25]], np.int64)

_LEVRUN_INTER = (4, 2, 2, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0)
_NTAB_INTER = ((1, 3, 5, 9, 11, 13, 21, 23, 25, 27),
               (7, 17, 19, 0, 0, 0, 0, 0, 0, 0),
               (15, 0, 0, 0, 0, 0, 0, 0, 0, 0),
               (29, 0, 0, 0, 0, 0, 0, 0, 0, 0))
_LEVRUN_C2 = (2, 1, 0, 0)
_NTAB_C2 = ((1, 5), (3, 0))


def _uvlc_len(n: int) -> int:
    nn, i = n >> 1, 0
    while nn:
        nn >>= 1
        i += 1
    return 2 * i + 1


def levrun_len_inter(level: int, run: int) -> int:
    """UVLC length of a (level, run) pair (lencod vlc.c
    levrun_linfo_inter:399), the rate term of the SP level decision."""
    la = abs(level)
    if la <= _LEVRUN_INTER[run]:
        n = _NTAB_INTER[la - 1][run] + 1
    else:
        n = (la - _LEVRUN_INTER[run]) * 32 + run * 2
    return _uvlc_len(n)


def levrun_len_c2x2(level: int, run: int) -> int:
    la = abs(level)
    if la <= _LEVRUN_C2[run]:
        n = _NTAB_C2[la - 1][run] + 1
    else:
        n = (la - _LEVRUN_C2[run]) * 8 + run * 2
    return _uvlc_len(n)


def _isignab(a: int, b: int) -> int:
    return -abs(a) if b < 0 else abs(a)


def sp_quant_coeffs(Xs, Ps, qp: int, qs: int, lam: float, shift: int,
                    A_s, rate_fn, run0: int = -1):
    """The scan-ordered SP level decision of one block: Xs / Ps the
    source's and the prediction's transform in scan order; shift 6 (4x4)
    or 5 (chroma DC); A_s each scan position's (A factor, raster index).
    Each coefficient takes the level of the prediction requantized at QS
    and the plain level of the difference, and where they differ and
    neither is 0 the one of least float64 d*d + lam*rate (the smaller
    magnitude on a tie). Returns (levels, ilevs = P + dequantA(level)),
    both in scan order."""
    qp_per, qp_rem = qp // 6, qp % 6
    qs_per, qs_rem = qs // 6, qs % 6
    extra = 1 if shift == 5 else 0           # chroma DC uses q_bits+1
    q_bits = 15 + qp_per + extra
    q_bits_sp = 15 + qs_per + extra
    qp_const = ((1 << q_bits) // 6) if not extra else 2 * ((1 << (q_bits - 1)) // 6)
    qp_const2 = (1 << q_bits_sp) >> 1
    if extra:
        qp_const2 = 2 * ((1 << (q_bits_sp - 1)) >> 1)
    Qqp = QUANT_SCALE_4x4[qp_rem]
    Qqs = QUANT_SCALE_4x4[qs_rem]
    Dqp = DEQUANT_SCALE_4x4[qp_rem]
    n = len(Xs)
    levels = [0] * n
    ilevs = [0] * n
    run = run0
    for k in range(n):
        run += 1
        X, P = int(Xs[k]), int(Ps[k])
        Qs_k, Qp_k, Dp_k, A_k = (int(Qqs.flat[A_s[k][1]]),
                                 int(Qqp.flat[A_s[k][1]]),
                                 int(Dqp.flat[A_s[k][1]]), int(A_s[k][0]))
        l1p = (abs(P) * Qs_k + qp_const2) >> q_bits_sp
        l1d = (l1p << q_bits_sp) // Qs_k
        c_err1 = X - _isignab(l1d, P)
        l1 = (abs(c_err1) * Qp_k + qp_const) >> q_bits
        c_err2 = X - P
        l2 = (abs(c_err2) * Qp_k + qp_const) >> q_bits

        def deq(lv, ce):
            return (_isignab(lv, ce) * Dp_k * A_k << qp_per) >> shift

        if l1 != l2 and l1 != 0 and l2 != 0:
            d1 = X - deq(l1, c_err1) - P
            d2 = X - deq(l2, c_err2) - P
            r1 = rate_fn(l1, run)
            r2 = rate_fn(l2, run)
            D1 = d1 * d1 + lam * r1
            D2 = d2 * d2 + lam * r2
            if D1 == D2:
                level, c_err = ((l1, c_err1) if abs(l1) < abs(l2)
                                else (l2, c_err2))
            elif D1 < D2:
                level, c_err = l1, c_err1
            else:
                level, c_err = l2, c_err2
        elif l1 == l2:
            level, c_err = l1, c_err1
        else:
            level, c_err = (l1, c_err1) if l1 == 0 else (l2, c_err2)

        ilev = 0
        if level != 0:
            level = _isignab(level, c_err)
            levels[k] = level
            run = -1
            ilev = (level * Dp_k * A_k << qp_per) >> shift
        ilevs[k] = ilev + P
    return levels, ilevs


_ZZ4 = ((0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
        (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3))


def sp_quant_rows(Xs, Ps, qp: int, qs: int, lam: float, shift: int, A_s,
                  rate_fn, native: bool = True):
    """sp_quant_coeffs' levels of every row of Xs / Ps ((K, n) int), each
    row from run -1: (K, n) int64. native: the port's C++ runtime
    (jm_enc.cpp sp_levels, the same arithmetic, its float64 costs summed
    as Python sums them); else the Python loop, its twin."""
    Xs = np.ascontiguousarray(Xs, np.int64)
    Ps = np.ascontiguousarray(Ps, np.int64)
    if not native:
        return np.array([sp_quant_coeffs(x, p, qp, qs, lam, shift, A_s,
                                         rate_fn)[0] for x, p in zip(Xs, Ps)],
                        np.int64).reshape(Xs.shape)
    out = np.empty_like(Xs)
    scales = np.stack([QUANT_SCALE_4x4[qs % 6].ravel(),
                       QUANT_SCALE_4x4[qp % 6].ravel(),
                       DEQUANT_SCALE_4x4[qp % 6].ravel()]).astype(np.int64)
    N.load().sp_levels(Xs, Ps, out, (qp, qs, shift,
                                     0 if rate_fn is levrun_len_inter
                                     else 1), float(lam),
                       np.array([a for a, _ in A_s], np.int64),
                       np.array([p for _, p in A_s], np.int64), scales)
    return out


def sp_requant_4x4(ilev_raster, qs: int):
    """The decoder's requantization of the transform-domain mix at QS:
    sign * ((|ilev| * MF_qs + half) >> q_bits) * V_qs << qs_per."""
    qs_per, qs_rem = qs // 6, qs % 6
    q_bits_sp = 15 + qs_per
    half = 1 << (q_bits_sp - 1)
    Q = QUANT_SCALE_4x4[qs_rem].astype(np.int64)
    D = DEQUANT_SCALE_4x4[qs_rem].astype(np.int64)
    il = np.asarray(ilev_raster, np.int64)
    lv = np.sign(il) * ((np.abs(il) * Q + half) >> q_bits_sp)
    return (lv * D) << qs_per


_A_SCAN = None


def _a_scan():
    global _A_SCAN
    if _A_SCAN is None:
        _A_SCAN = [(int(SP_A[j][i]), j * 4 + i) for (j, i) in _ZZ4]
    return _A_SCAN


def sp_luma_levels_mb(orig_blks, pred_blks, qp: int, qs: int, lam: float,
                      native: bool = True):
    """The SP levels of a batch of luma 4x4 blocks ((K, 4, 4) each; jm_tpu
    residual_np.sp_luma_levels block by block): (the levels in scan order
    (K, 16), the prediction's transforms (K, 4, 4)); native as in
    sp_quant_rows."""
    X = np_forward4x4(np.asarray(orig_blks, np.int64))
    P = np_forward4x4(np.asarray(pred_blks, np.int64))
    k = X.shape[0]
    levels = sp_quant_rows(X.reshape(k, 16)[:, _ZZ],
                           P.reshape(k, 16)[:, _ZZ], qp, qs, lam, 6,
                           _a_scan(), levrun_len_inter, native)
    return levels, P


def sp_luma_recon(P_raster, scan_levels, qp: int, qs: int):
    """The recon of one (or a batch of) SP luma 4x4 from its final
    levels: base = P + dequantA(level), requantized at QS, inverse
    transform, clip (the decoder's ops/dec.sp_recon arithmetic)."""
    qp_per, qp_rem = qp // 6, qp % 6
    Dqp = DEQUANT_SCALE_4x4[qp_rem].astype(np.int64)
    lev = from_scan(np.asarray(scan_levels, np.int64))
    base = P_raster + ((lev * Dqp * SP_A) << qp_per >> 6)
    cof = sp_requant_4x4(base, qs)
    res = _np_inv4(cof)
    return np.clip((res + (1 << 5)) >> 6, 0, 255)


def _h2(M):
    """JM's hadamard2x2 of the four DCs of a (2, 2, 4, 4) [by][bx]
    transform stack, in ldecod itrans_sp_cr's order (block.c:530): m[1]
    flips the row dimension."""
    a, b = M[0, 0, 0, 0], M[1, 0, 0, 0]
    c, d = M[0, 1, 0, 0], M[1, 1, 0, 0]
    return [int(a + b + c + d), int(a - b + c - d),
            int(a + b - c - d), int(a - b - c + d)]


def sp_chroma_levels(orig8, pred8, qp_c: int, qs_c: int, lam: float,
                     native: bool = True):
    """One 4:2:0 chroma component (8x8): (DC levels in scan order (4,),
    AC levels in scan order (4, 16) with [:, 0] = 0, the prediction's
    transforms (2, 2, 4, 4), their DC Hadamard mp1 (4,)); the levels by
    sp_quant_rows (native: the C++ runtime, else the Python loop)."""
    ob = orig8.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).astype(np.int64)
    pb = pred8.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).astype(np.int64)
    X = np_forward4x4(ob.reshape(4, 4, 4)).reshape(2, 2, 4, 4)
    P = np_forward4x4(pb.reshape(4, 4, 4)).reshape(2, 2, 4, 4)
    m1, mp1 = _h2(X), _h2(P)
    dc_levels = sp_quant_rows([m1], [mp1], qp_c, qs_c, lam, 5,
                              [(16, 0)] * 4, levrun_len_c2x2, native)[0]
    # the AC of blocks by * 2 + bx, scan positions 1..15
    ac_levels = np.zeros((4, 16), np.int64)
    A_s = [(int(SP_A[j][i]), j * 4 + i) for (j, i) in _ZZ4[1:]]
    ac_levels[:, 1:] = sp_quant_rows(
        X.reshape(4, 16)[:, _ZZ[1:]], P.reshape(4, 16)[:, _ZZ[1:]],
        qp_c, qs_c, lam, 6, A_s, levrun_len_inter, native)
    return dc_levels, ac_levels, P, np.array(mp1)


def sp_chroma_recon(P, mp1, dc_levels, ac_scan, qp_c: int, qs_c: int):
    """The recon of one SP chroma component (8x8) from its final levels
    (the decoder's ops/dec.sp_recon arithmetic)."""
    qp_per, qp_rem = qp_c // 6, qp_c % 6
    qs_per, qs_rem = qs_c // 6, qs_c % 6
    qb = 15 + qs_per
    Dqp = DEQUANT_SCALE_4x4[qp_rem].astype(np.int64)
    Q00 = int(QUANT_SCALE_4x4[qs_rem][0, 0])
    D00 = int(DEQUANT_SCALE_4x4[qs_rem][0, 0])
    half2 = 1 << qb
    bdc = np.asarray(mp1, np.int64) + \
        ((np.asarray(dc_levels, np.int64) * int(Dqp[0, 0]) * 16)
         << qp_per >> 5)
    ildc = np.sign(bdc) * ((np.abs(bdc) * Q00 + half2) >> (qb + 1))
    m1q = (ildc * D00) << qs_per
    lev = from_scan(np.asarray(ac_scan, np.int64)).reshape(2, 2, 4, 4)
    base = P + ((lev * Dqp * SP_A) << qp_per >> 6)
    cof = sp_requant_4x4(base, qs_c)
    cof[0, 0, 0, 0] = (m1q[0] + m1q[1] + m1q[2] + m1q[3]) >> 1
    cof[0, 1, 0, 0] = (m1q[0] + m1q[1] - m1q[2] - m1q[3]) >> 1
    cof[1, 0, 0, 0] = (m1q[0] - m1q[1] + m1q[2] - m1q[3]) >> 1
    cof[1, 1, 0, 0] = (m1q[0] - m1q[1] - m1q[2] + m1q[3]) >> 1
    res = _np_inv4(cof)
    rec = np.clip((res + (1 << 5)) >> 6, 0, 255)
    return rec.transpose(0, 2, 1, 3).reshape(8, 8)
