"""CAVLC residual block decoding (spec 9.2), twin of
jm_tpu/decoder/cavlc.py (ldecod/src/vlc.c
readSyntaxElement_NumCoeffTrailingOnes:695, _TotalZeros:997, _Run:1152).

The code tables are those of common/cavlc_tables.py, each compiled into a
flat peek table (prefix-expanded), so one codeword decodes with one
lookup.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitreader import BitReader
from ..common.cavlc_tables import (_CT_COD, _CT_DC_COD, _CT_DC_LEN, _CT_LEN,
                                   _RUN_COD, _RUN_LEN, _TZ_COD, _TZ_DC_COD,
                                   _TZ_DC_LEN, _TZ_LEN)


def _compile_lut(entries, width):
    """entries: iterable of (length, code, payload). Returns an int32 array
    of 2^width entries holding (payload << 8) | length, 0 where invalid."""
    lut = np.zeros(1 << width, dtype=np.int32)
    for length, code, payload in entries:
        if length == 0:
            continue
        lo = code << (width - length)
        lut[lo:lo + (1 << (width - length))] = (payload << 8) | length
    return lut


def _ct_entries(lentab, codtab):
    for t1 in range(4):
        for tc in range(len(lentab[t1])):
            if lentab[t1][tc]:
                yield lentab[t1][tc], codtab[t1][tc], (tc << 2) | t1


_CT_W = 16
CT_LUT = [_compile_lut(_ct_entries(_CT_LEN[i], _CT_COD[i]), _CT_W)
          for i in range(3)]
# chroma DC: [4:2:0 (nC -1), 4:2:2 (nC -2)]
CT_DC_LUT = [_compile_lut(_ct_entries(_CT_DC_LEN[i], _CT_DC_COD[i]), _CT_W)
             for i in range(2)]

_TZ_W = 9
TZ_LUT = [_compile_lut(
    ((_TZ_LEN[i][z], _TZ_COD[i][z], z) for z in range(len(_TZ_LEN[i]))), _TZ_W)
    for i in range(15)]
TZ_DC_LUT = [[_compile_lut(
    ((ln[z], cd[z], z) for z in range(len(ln))), _TZ_W)
    for ln, cd in zip(_TZ_DC_LEN[i], _TZ_DC_COD[i])] for i in range(2)]

_RUN_W = 11
RUN_LUT = [_compile_lut(
    ((_RUN_LEN[i][r], _RUN_COD[i][r], r) for r in range(len(_RUN_LEN[i]))),
    _RUN_W) for i in range(7)]


def _read_lut(br: BitReader, lut: np.ndarray, width: int) -> int:
    """Decode one codeword; returns its payload. Raises on an invalid code."""
    v = int(lut[br.peek_pad(width)])
    if v == 0:
        raise ValueError(f"invalid VLC codeword at bit {br.pos}")
    br.pos += v & 0xFF
    return v >> 8


def read_coeff_token(br: BitReader, nc: int) -> tuple[int, int]:
    """Returns (total_coeff, trailing_ones); nc = -1: 4:2:0 chroma DC,
    -2: 4:2:2 chroma DC."""
    if nc >= 8:
        code = br.u(6)
        t1 = code & 3
        tc = code >> 2
        if tc == 0 and t1 == 3:
            return 0, 0
        return tc + 1, t1
    if nc >= 0:
        lut = CT_LUT[0 if nc < 2 else (1 if nc < 4 else 2)]
    else:
        lut = CT_DC_LUT[-1 - nc]
    payload = _read_lut(br, lut, _CT_W)
    return payload >> 2, payload & 3


def residual_block_cavlc(br: BitReader, nc: int,
                         max_coeff: int) -> tuple[np.ndarray, int]:
    """Decode one CAVLC residual block (spec 9.2.2 / 9.2.3). Returns
    (max_coeff coefficients in scan order, total_coeff)."""
    out = np.zeros(max_coeff, dtype=np.int32)
    total_coeff, trailing_ones = read_coeff_token(br, nc)
    if total_coeff == 0:
        return out, 0

    suffix_len = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    levels = [0] * total_coeff
    for i in range(total_coeff):
        if i < trailing_ones:
            levels[i] = 1 - 2 * br.flag()
            continue
        prefix = br.zeros_until_one(limit=32)
        if prefix == 14 and suffix_len == 0:
            size = 4
        elif prefix >= 15:
            size = prefix - 3
        else:
            size = suffix_len
        level_code = min(15, prefix) << suffix_len
        if size > 0:
            level_code += br.u(size)
        if prefix >= 15 and suffix_len == 0:
            level_code += 15
        if prefix >= 16:
            level_code += (1 << (prefix - 3)) - 4096
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        if level_code % 2 == 0:
            level = (level_code + 2) >> 1
        else:
            level = (-level_code - 1) >> 1
        levels[i] = level
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    if total_coeff < max_coeff:
        tabs = {4: TZ_DC_LUT[0], 8: TZ_DC_LUT[1]}.get(max_coeff, TZ_LUT)
        lut = tabs[total_coeff - 1]
        total_zeros = _read_lut(br, lut, _TZ_W)
    else:
        total_zeros = 0

    pos = total_coeff - 1 + total_zeros
    zeros_left = total_zeros
    for i in range(total_coeff):
        out[pos] = levels[i]
        if i == total_coeff - 1:
            break
        if zeros_left > 0:
            run = _read_lut(br, RUN_LUT[min(zeros_left, 7) - 1], _RUN_W)
        else:
            run = 0
        zeros_left -= run
        pos -= run + 1
    return out, total_coeff
