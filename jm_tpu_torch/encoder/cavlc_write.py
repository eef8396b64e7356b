"""CAVLC residual encoding (spec 9.2, write side).

Exact inverse of jm_tpu.decoder.cavlc (shares its normative code tables).
Capability parity with lencod/src/vlc.c (writeSyntaxElement_NumCoeffTrailingOnes
:820, _TotalZeros:994, _Run, writeSyntaxElement_Level_VLC0/VLCN) — new
implementation; every write is round-trip-tested against the decoder.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitwriter import BitWriter
from ..common.cavlc_tables import (_CT_COD, _CT_DC_COD, _CT_DC_LEN, _CT_LEN,
                             _RUN_COD, _RUN_LEN, _TZ_COD, _TZ_DC_COD,
                             _TZ_DC_LEN, _TZ_LEN)


def write_coeff_token(bw: BitWriter, nc: int, total_coeff: int,
                      trailing_ones: int) -> None:
    if nc >= 8:
        if total_coeff == 0:
            bw.u(3, 6)  # tc=0 encoded as (0, 3)
        else:
            bw.u(((total_coeff - 1) << 2) | trailing_ones, 6)
        return
    if nc >= 0:
        tab_i = 0 if nc < 2 else (1 if nc < 4 else 2)
        lentab, codtab = _CT_LEN[tab_i], _CT_COD[tab_i]
    else:
        tab_i = 0 if nc == -1 else 1
        lentab, codtab = _CT_DC_LEN[tab_i], _CT_DC_COD[tab_i]
    ln = lentab[trailing_ones][total_coeff]
    if ln == 0:
        raise ValueError(f"invalid coeff_token tc={total_coeff} t1={trailing_ones}")
    bw.u(codtab[trailing_ones][total_coeff], ln)


def _write_level(bw: BitWriter, level: int, suffix_len: int,
                 adjust: bool) -> None:
    """Encode one non-trailing level; mirror of the spec 9.2.2.1 decode."""
    if level > 0:
        level_code = 2 * level - 2
    else:
        level_code = -2 * level - 1
    if adjust:
        level_code -= 2
    if suffix_len == 0:
        if level_code < 14:
            bw.u(1, level_code + 1)          # level_code zeros then a 1
        elif level_code < 30:
            bw.u(1, 15)                      # prefix 14
            bw.u(level_code - 14, 4)
        elif level_code < 30 + 4096:
            bw.u(1, 16)                      # prefix 15
            bw.u(level_code - 30, 12)
        else:
            raise NotImplementedError("extended level prefix >= 16")
    else:
        prefix = level_code >> suffix_len
        if prefix < 15:
            bw.u(1, prefix + 1)
            bw.u(level_code & ((1 << suffix_len) - 1), suffix_len)
        else:
            esc = level_code - (15 << suffix_len)
            if esc < 4096:
                bw.u(1, 16)
                bw.u(esc, 12)
            else:
                raise NotImplementedError("extended level prefix >= 16")


def write_residual_block(bw: BitWriter, coeffs_scan: np.ndarray, nc: int,
                         max_coeff: int) -> int:
    """Write one residual block (coefficients in scan order).

    Returns total_coeff (for nnz bookkeeping).
    """
    c = np.asarray(coeffs_scan[:max_coeff])
    nz = np.flatnonzero(c)
    total_coeff = len(nz)
    if total_coeff > max_coeff:
        raise ValueError("too many coefficients")

    # trailing ones: run of |1| at the high-frequency end, capped at 3
    trailing = 0
    for idx in nz[::-1]:
        if abs(int(c[idx])) == 1 and trailing < 3:
            trailing += 1
        else:
            break

    write_coeff_token(bw, nc, total_coeff, trailing)
    if total_coeff == 0:
        return 0

    # trailing one signs, highest frequency first
    for idx in nz[::-1][:trailing]:
        bw.u(1 if c[idx] < 0 else 0, 1)

    # levels, high -> low frequency
    suffix_len = 1 if (total_coeff > 10 and trailing < 3) else 0
    first = True
    for idx in nz[::-1][trailing:]:
        level = int(c[idx])
        _write_level(bw, level, suffix_len, adjust=first and trailing < 3)
        first = False
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total zeros
    total_zeros = int(nz[-1]) + 1 - total_coeff
    if total_coeff < max_coeff:
        vlcnum = total_coeff - 1
        if max_coeff == 4:
            lentab, codtab = _TZ_DC_LEN[0][vlcnum], _TZ_DC_COD[0][vlcnum]
        elif max_coeff == 8:
            lentab, codtab = _TZ_DC_LEN[1][vlcnum], _TZ_DC_COD[1][vlcnum]
        else:
            lentab, codtab = _TZ_LEN[vlcnum], _TZ_COD[vlcnum]
        bw.u(codtab[total_zeros], lentab[total_zeros])

    # run_before, high -> low; stop when zeros exhausted or last coeff
    zeros_left = total_zeros
    for j in range(total_coeff - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = int(nz[j]) - int(nz[j - 1]) - 1
        vlc = min(zeros_left, 7) - 1
        bw.u(_RUN_COD[vlc][run], _RUN_LEN[vlc][run])
        zeros_left -= run
    return total_coeff


def _level_bits(level: int, suffix_len: int, adjust: bool) -> int:
    """The length of one non-trailing level as _write_level writes it."""
    level_code = 2 * level - 2 if level > 0 else -2 * level - 1
    if adjust:
        level_code -= 2
    if suffix_len == 0:
        if level_code < 14:
            return level_code + 1
        if level_code < 30:
            return 19
        if level_code < 30 + 4096:
            return 28
    else:
        prefix = level_code >> suffix_len
        if prefix < 15:
            return prefix + 1 + suffix_len
        if level_code - (15 << suffix_len) < 4096:
            return 28
    raise NotImplementedError("extended level prefix >= 16")


def residual_block_bits(coeffs, nc: int, max_coeff: int) -> int:
    """The number of bits write_residual_block writes for coeffs (a
    sequence of ints in scan order), counted without writing them: the
    rate of the trellis and of the RD mode decision."""
    nz = [i for i in range(max_coeff) if coeffs[i]]
    total_coeff = len(nz)
    trailing = 0
    for idx in reversed(nz):
        if coeffs[idx] in (1, -1) and trailing < 3:
            trailing += 1
        else:
            break
    if nc >= 8:
        bits = 6
    else:
        if nc >= 0:
            lentab = _CT_LEN[0 if nc < 2 else (1 if nc < 4 else 2)]
        else:
            lentab = _CT_DC_LEN[0 if nc == -1 else 1]
        bits = lentab[trailing][total_coeff]
        if bits == 0:
            raise ValueError(f"invalid coeff_token tc={total_coeff} "
                             f"t1={trailing}")
    if total_coeff == 0:
        return bits
    bits += trailing
    suffix_len = 1 if (total_coeff > 10 and trailing < 3) else 0
    first = True
    for idx in reversed(nz[:total_coeff - trailing]):
        level = int(coeffs[idx])
        bits += _level_bits(level, suffix_len, first and trailing < 3)
        first = False
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    total_zeros = nz[-1] + 1 - total_coeff
    if total_coeff < max_coeff:
        vlcnum = total_coeff - 1
        if max_coeff == 4:
            bits += _TZ_DC_LEN[0][vlcnum][total_zeros]
        elif max_coeff == 8:
            bits += _TZ_DC_LEN[1][vlcnum][total_zeros]
        else:
            bits += _TZ_LEN[vlcnum][total_zeros]
    zeros_left = total_zeros
    for j in range(total_coeff - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = nz[j] - nz[j - 1] - 1
        bits += _RUN_LEN[min(zeros_left, 7) - 1][run]
        zeros_left -= run
    return bits
