"""Normative constant tables from ISO/IEC 14496-10 (H.264).

These are spec tables, not code: the 4x4 and 8x8 zig-zag scans (Table
8-13), the 4x4 and 8x8 quantizer scale matrices (8.5.12, 8.5.13), chroma
QP mapping (Table 8-15), deblocking alpha/beta/tc0 (Table 8-16). The
reference keeps the same values in lcommon/inc/ctx_tables.h,
ldecod/src/quant.c, ldecod/src/loop_filter_normal.c.
"""

from __future__ import annotations

import numpy as np

# -- scan orders -------------------------------------------------------------

# 4x4 zig-zag scan: sequence of (row, col) == (j, i); flat index = 4*j + i
ZIGZAG_4x4 = np.array(
    [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], dtype=np.int32)

# 4x4 field scan of field pictures (Table 8-13, ldecod FIELD_SCAN),
# flat index = 4*j + i
FIELD_SCAN_4x4 = np.array(
    [0, 4, 1, 8, 12, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15], dtype=np.int32)


def scan_4x4(field: bool) -> np.ndarray:
    """The 4x4 coefficient scan of a field picture (field True) or of a
    frame picture (spec 8.5.6)."""
    return FIELD_SCAN_4x4 if field else ZIGZAG_4x4

# 8x8 zig-zag scan, flat index = 8*j + i
ZIGZAG_8x8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# 4:2:2 chroma DC scan: (column, row) of the 2x4 DC array per
# transmission position (ldecod/inc/macroblock.h:63 SCAN_YUV422)
SCAN_YUV422 = [(0, 0), (0, 1), (1, 0), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3)]

# -- 4x4 quantizer scale classes --------------------------------------------
# position class for (j, i): 0 for both even/even "corner" {(0,0),(0,2),(2,0),(2,2)},
# 1 for both odd {(1,1),(1,3),(3,1),(3,3)}, 2 otherwise.

_POS4 = np.zeros((4, 4), dtype=np.int32)
for _j in range(4):
    for _i in range(4):
        if _j % 2 == 0 and _i % 2 == 0:
            _POS4[_j, _i] = 0
        elif _j % 2 == 1 and _i % 2 == 1:
            _POS4[_j, _i] = 1
        else:
            _POS4[_j, _i] = 2

# normAdjust4x4[m][class] (spec 8-252): dequant scale V
_NORM_ADJUST_4 = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# forward quant MF[m][class] (JM lencod quant_coef; MF = 2^26 / (V * 16) class-wise)
_QUANT_MF_4 = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

# (6, 4, 4) expanded tables
DEQUANT_SCALE_4x4 = _NORM_ADJUST_4[:, _POS4]       # V[m, j, i]
QUANT_SCALE_4x4 = _QUANT_MF_4[:, _POS4]            # MF[m, j, i]

# -- 8x8 quantizer scale classes --------------------------------------------
# by (j % 4, i % 4): 0 (0, 0); 1 both odd; 2 (2, 2); 3 one 0, the other
# odd; 4 (0, 2) or (2, 0); 5 one 2, the other odd

_CLASS8 = np.array([[0, 3, 4, 3],
                    [3, 1, 5, 1],
                    [4, 5, 2, 5],
                    [3, 1, 5, 1]], dtype=np.int32)
_POS8 = np.tile(_CLASS8, (2, 2))

# normAdjust8x8[m][class] (spec 8-317): dequant scale V8
_NORM_ADJUST_8 = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int32)

# forward quant MF8[m][class] (JM lencod quant_coef8)
_QUANT_MF_8 = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640],
], dtype=np.int32)

# (6, 8, 8) expanded tables
DEQUANT_SCALE_8x8 = _NORM_ADJUST_8[:, _POS8]
QUANT_SCALE_8x8 = _QUANT_MF_8[:, _POS8]

# -- chroma QP mapping (Table 8-15) -----------------------------------------

QP_CHROMA_MAP = np.array(
    [i for i in range(30)] +
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38,
     39, 39, 39, 39],
    dtype=np.int32)  # index by Clip3(0, 51, qPi); negative qPi handled by caller


def chroma_qp(qp_y: int, offset: int, bitdepth_chroma: int = 8) -> int:
    qpi = max(-6 * (bitdepth_chroma - 8), min(51, qp_y + offset))
    return int(QP_CHROMA_MAP[qpi]) if qpi >= 0 else qpi


# -- deblocking tables (Table 8-16) -----------------------------------------

ALPHA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
    32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144,
    162, 182, 203, 226, 255, 255], dtype=np.int32)

BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
    16, 16, 17, 17, 18, 18], dtype=np.int32)

# tc0 for bS = 1, 2, 3 (rows) by indexA (cols 0..51), spec Table 8-17
TC0_TABLE = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8,
     9, 10, 11, 13],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
     2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11,
     12, 13, 15, 17],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
     3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16,
     18, 20, 23, 25],
], dtype=np.int32)
