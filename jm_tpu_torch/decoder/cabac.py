"""CABAC decoding (spec 9.3): the arithmetic decoding engine, the context
models of one slice and the residual block reader; twin of
jm_tpu/decoder/cabac.py (the engine, the context initialization and
``read_significance_and_levels``) for I and P slices. As there,
``CabacEngine`` is the native engine of the port's C++ runtime
(jm_tpu_torch/native, jm_native.cpp; it takes a native BitReader) and
``PyCabacEngine`` its Python twin with the same API.

Capability parity with ldecod/src/biaridecod.c (arithmetic core),
context_ini.c (init_contexts) and cabac.c (read_significance_map,
read_significant_coefficients). The engine renormalizes bit by bit, as
the spec writes it; ldecod's 16-bit variant consumes the same bins. The
encoder (encoder/cabac_write.py, encoder/syntax_cabac.py) takes its
block-type constants and context tables from here.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..bitstream.bitreader import BitReader
from ..common import cabac_tables as CT

# CABAC block types (residual context categories, ldecod cabac.c)
LUMA_16DC, LUMA_16AC, LUMA_8x8, LUMA_8x4, LUMA_4x8, LUMA_4x4 = range(6)
CHROMA_DC, CHROMA_AC, CHROMA_DC_2x4, CHROMA_DC_4x4 = 6, 7, 8, 9

MAXPOS = [15, 14, 63, 31, 31, 15, 3, 14, 7, 15, 15, 14, 63, 31, 31, 15,
          15, 14, 63, 31, 31, 15]
C1ISDC = [1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1]
TYPE2CTX_BCBP = [0, 1, 2, 3, 3, 4, 5, 6, 5, 5, 10, 11, 12, 13, 13, 14, 16,
                 17, 18, 19, 19, 20]
TYPE2CTX_MAP = [0, 1, 2, 3, 4, 5, 6, 7, 6, 6, 10, 11, 12, 13, 14, 15, 16,
                17, 18, 19, 20, 21]
TYPE2CTX_LAST = TYPE2CTX_MAP
TYPE2CTX_ONE = TYPE2CTX_BCBP
TYPE2CTX_ABS = TYPE2CTX_BCBP
MAX_C2 = [4, 4, 4, 4, 4, 4, 3, 4, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4]

POS2CTX_MAP8X8 = [0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
                  4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
                  7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
                  12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12, 14]
POS2CTX_MAP4X4 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 14]
POS2CTX_MAP2X4C = [0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2]
POS2CTX_MAP4X4C = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2]

POS2CTX_LAST8X8 = [0] + [1] * 15 + [2] * 16 + [3] * 8 + [4] * 8 + \
    [5] * 4 + [6] * 4 + [7] * 4 + [8] * 4
POS2CTX_LAST4X4 = list(range(16))
POS2CTX_LAST2X4C = POS2CTX_MAP2X4C
POS2CTX_LAST4X4C = POS2CTX_MAP4X4C

# the coder's tables as Python lists: one lookup per bin
RANGE_LPS = CT.RANGE_LPS.tolist()
NEXT_STATE_MPS = CT.NEXT_STATE_MPS.tolist()
NEXT_STATE_LPS = CT.NEXT_STATE_LPS.tolist()


def pos2ctx_map(block_type):
    if block_type in (LUMA_8x8, 12, 18):
        return POS2CTX_MAP8X8
    if block_type == CHROMA_DC_2x4:
        return POS2CTX_MAP2X4C
    if block_type == CHROMA_DC_4x4:
        return POS2CTX_MAP4X4C
    return POS2CTX_MAP4X4


def pos2ctx_last(block_type):
    if block_type in (LUMA_8x8, 12, 18):
        return POS2CTX_LAST8X8
    if block_type == CHROMA_DC_2x4:
        return POS2CTX_LAST2X4C
    if block_type == CHROMA_DC_4x4:
        return POS2CTX_LAST4X4C
    return POS2CTX_LAST4X4


def CabacEngine(br):
    """The default engine: a jm_torch_native.CabacEngine over the native
    reader ``br``, positioned like PyCabacEngine's."""
    return native.load().CabacEngine(br)


class PyCabacEngine:
    """Arithmetic decoder (spec 9.3.3.2), bit-serial renormalization. A
    context group is an (..., 2) int32 array of [state, MPS] rows; a
    decision reads and updates row ``idx`` in place."""

    __slots__ = ("br", "rng", "offset")

    def __init__(self, br: BitReader):
        br.align()
        self.br = br
        self.rng = 510
        self.offset = br.u(9)

    def decision(self, ctx: np.ndarray, idx: int) -> int:
        row = ctx[idx]
        state = int(row[0])
        mps = int(row[1])
        r_lps = RANGE_LPS[state][(self.rng >> 6) & 3]
        rng = self.rng - r_lps
        if self.offset >= rng:
            bit = 1 - mps
            self.offset -= rng
            rng = r_lps
            if state == 0:
                row[1] = 1 - mps
            row[0] = NEXT_STATE_LPS[state]
        else:
            bit = mps
            row[0] = NEXT_STATE_MPS[state]
        if rng < 256:
            flag = self.br.flag
            offset = self.offset
            while rng < 256:
                rng <<= 1
                offset = (offset << 1) | flag()
            self.offset = offset
        self.rng = rng
        return bit

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self.br.flag()
        if self.offset >= self.rng:
            self.offset -= self.rng
            return 1
        return 0

    def terminate(self) -> int:
        self.rng -= 2
        if self.offset >= self.rng:
            return 1
        while self.rng < 256:
            self.rng <<= 1
            self.offset = (self.offset << 1) | self.br.flag()
        return 0

    # ---- composite binarizations -------------------------------------

    def unary(self, ctx, first_idx, rest_idx) -> int:
        if not self.decision(ctx, first_idx):
            return 0
        n = 0
        while True:
            n += 1
            if not self.decision(ctx, rest_idx):
                return n

    def unary_max(self, ctx, first_idx, rest_idx, max_symbol) -> int:
        sym = self.decision(ctx, first_idx)
        if sym == 0 or max_symbol == 0:
            return sym
        sym = 0
        while True:
            bit = self.decision(ctx, rest_idx)
            sym += 1
            if bit == 0 or sym >= max_symbol:
                break
        if bit != 0 and sym == max_symbol:
            sym += 1
        return sym

    def exp_golomb_eq_prob(self, k: int) -> int:
        sym = 0
        while self.bypass() == 1:
            sym += 1 << k
            k += 1
        val = 0
        while k:
            k -= 1
            if self.bypass():
                val |= 1 << k
        return sym + val

    def ueg0_level(self, ctx, idx) -> int:
        """coeff_abs_level_minus1 - 1: truncated unary (13 bins) on one
        context, then an Exp-Golomb order-0 bypass escape."""
        if not self.decision(ctx, idx):
            return 0
        sym, k = 0, 1
        while True:
            bit = self.decision(ctx, idx)
            sym += 1
            k += 1
            if bit == 0 or k == 13:
                break
        if bit != 0:
            sym += self.exp_golomb_eq_prob(0) + 1
        return sym

    def ueg3_mv(self, ctx, base_idx, max_bin=3) -> int:
        """|mvd| - 1: truncated unary over contexts base+1.. (8 bins), then
        an Exp-Golomb order-3 bypass escape."""
        if not self.decision(ctx, base_idx):
            return 0
        idx = base_idx + 1
        sym, k, binno = 0, 1, 1
        while True:
            bit = self.decision(ctx, idx)
            binno += 1
            if binno == 2:
                idx += 1
            if binno == max_bin:
                idx += 1
            sym += 1
            k += 1
            if bit == 0 or k == 8:
                break
        if bit != 0:
            sym += self.exp_golomb_eq_prob(3) + 1
        return sym


def _init_group(tab_i, tab_p, slice_type_intra: bool, model: int,
                qp: int) -> np.ndarray:
    """Initialize one context group (spec 9.3.1.1): (..., 2) int32 rows
    of [state, MPS]."""
    src = tab_i[0] if slice_type_intra else tab_p[model]
    m = src[..., 0].astype(np.int64)
    n = src[..., 1].astype(np.int64)
    pstate = ((m * qp) >> 4) + n
    out = np.zeros(src.shape, np.int32)
    ge = pstate >= 64
    out[..., 0] = np.where(ge, np.minimum(126, pstate) - 64,
                           63 - np.maximum(1, pstate))
    out[..., 1] = np.where(ge, 1, 0)
    return out


class CabacContexts:
    """All context groups of one slice (JM layout), initialized for an I
    slice or for P model ``model`` (cabac_init_idc) at slice QP ``qp``."""

    def __init__(self, slice_type_intra: bool, model: int, qp: int):
        qp = max(0, qp)

        def a(i, p):
            return _init_group(i, p, slice_type_intra, model, qp)

        self.mb_type = a(CT.INIT_MB_TYPE_I, CT.INIT_MB_TYPE_P)      # (3, 11, 2)
        self.b8_type = a(CT.INIT_B8_TYPE_I, CT.INIT_B8_TYPE_P)      # (2, 9, 2)
        self.mv_res = a(CT.INIT_MV_RES_I, CT.INIT_MV_RES_P)         # (2, 10, 2)
        self.ref_no = a(CT.INIT_REF_NO_I, CT.INIT_REF_NO_P)         # (2, 6, 2)
        self.delta_qp = a(CT.INIT_DELTA_QP_I, CT.INIT_DELTA_QP_P)[0]  # (4, 2)
        self.mb_aff = a(CT.INIT_MB_AFF_I, CT.INIT_MB_AFF_P)[0]
        self.transform_size = a(CT.INIT_TRANSFORM_SIZE_I,
                                CT.INIT_TRANSFORM_SIZE_P)[0]        # (3, 2)
        self.ipr = a(CT.INIT_IPR_I, CT.INIT_IPR_P)[0]               # (2, 2)
        self.cipr = a(CT.INIT_CIPR_I, CT.INIT_CIPR_P)[0]            # (4, 2)
        self.cbp = a(CT.INIT_CBP_I, CT.INIT_CBP_P)                  # (3, 4, 2)
        self.bcbp = a(CT.INIT_BCBP_I, CT.INIT_BCBP_P)               # (22, 4, 2)
        self.map = a(CT.INIT_MAP_I, CT.INIT_MAP_P)                  # (22, 15, 2)
        self.last = a(CT.INIT_LAST_I, CT.INIT_LAST_P)               # (22, 15, 2)
        self.one = a(CT.INIT_ONE_I, CT.INIT_ONE_P)                  # (22, 5, 2)
        self.abs = a(CT.INIT_ABS_I, CT.INIT_ABS_P)                  # (22, 5, 2)


def read_significance_and_levels(eng, ctxs: CabacContexts,
                                 block_type: int) -> np.ndarray:
    """Decode one residual block's coefficients (its coded_block_flag was
    1): the significance map, then the levels from the last significant
    position down. Returns the coefficients in scan order, length
    MAXPOS + 1 (for the AC types, position k is block scan k + 1)."""
    maxp = MAXPOS[block_type]
    n = maxp + 1
    coeff = [0] * n
    p2m = pos2ctx_map(block_type)
    p2l = pos2ctx_last(block_type)
    map_ctx = ctxs.map[TYPE2CTX_MAP[block_type]]
    last_ctx = ctxs.last[TYPE2CTX_LAST[block_type]]
    # AC categories (c1isdc == 0) index the position -> context tables
    # from 1 (ldecod cabac.c read_significance_map ++i0 / ++i1)
    off = 0 if C1ISDC[block_type] else 1
    got_last = False
    last_written = -1
    for k in range(n - 1):
        i = k + off
        if eng.decision(map_ctx, p2m[i]):
            coeff[k] = 1
            last_written = k
            if eng.decision(last_ctx, p2l[i]):
                got_last = True
                break
    if not got_last:
        coeff[n - 1] = 1
        last_written = n - 1
    one_ctx = ctxs.one[TYPE2CTX_ONE[block_type]]
    abs_ctx = ctxs.abs[TYPE2CTX_ABS[block_type]]
    max_c2 = MAX_C2[block_type]
    c1, c2 = 1, 0
    for i in range(last_written, -1, -1):
        if coeff[i] == 0:
            continue
        coeff[i] += eng.decision(one_ctx, c1)
        if coeff[i] == 2:
            coeff[i] += eng.ueg0_level(abs_ctx, c2)
            c2 = min(c2 + 1, max_c2)
            c1 = 0
        elif c1:
            c1 = min(c1 + 1, 4)
        if eng.bypass():
            coeff[i] = -coeff[i]
    return np.array(coeff, np.int64)
