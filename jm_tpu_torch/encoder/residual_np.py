"""Numpy residual coding of single macroblocks for the host coders
(encoder/p_intra.py, intra_host.py, b_host.py, p_host.py): the forward
4x4 and 8x8 transforms, flat quant, the 4x4 scans (the zig-zag of frame
pictures by default, or the caller's ``scan``: the field scan of field
pictures) and the 8x8 zig-zag, the decode-mirror recon of 4x4, 8x8 and Intra16x16 luma and of 4:2:0 and
4:2:2 chroma (flat, or with a scaling matrix's inverse table ``tab``;
the 4:2:2 chroma DC is a 2x4 Hadamard quantized at QPc + 3), and JM's
run-weighted coefficient costs. A trimmed copy of
jm_tpu/encoder/residual_np.py, whose module-global scan switch is an
argument here; the inverse halves are the
port's decoder's (decoder/recon.py), so the encoder's recon is what a
decoder reconstructs.
"""

from __future__ import annotations

import numpy as np

from ..common.tables import (DEQUANT_SCALE_8x8, QUANT_SCALE_4x4,
                             QUANT_SCALE_8x8, SCAN_YUV422, ZIGZAG_4x4,
                             ZIGZAG_8x8)
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
