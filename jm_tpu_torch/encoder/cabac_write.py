"""CABAC arithmetic encoder (spec 9.3.4), twin of
jm_tpu/encoder/cabac_write.py's CabacEncoder: decision, bypass and
terminate bins with the spec's bit-serial renormalization and
outstanding-bit tracking (lencod/src/biariencode.c biari_encode_symbol,
biari_encode_symbol_eq_prob, biari_encode_symbol_final), and the
composite binarizations that invert decoder/cabac.CabacEngine's.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitwriter import BitWriter
from ..decoder.cabac import NEXT_STATE_LPS, NEXT_STATE_MPS, RANGE_LPS


class CabacEncoder:
    """Arithmetic encoder writing into a BitWriter. ``bins`` counts the
    bins coded (lencod's set_pic_bin_count), which the Clause 7.4.2.10
    cabac_zero_word constraint reads; ``bits_out`` counts the bits the
    coded bins determine, outstanding ones included."""

    def __init__(self, bw: BitWriter):
        self.bw = bw
        self.low = 0
        self.rng = 510
        self.outstanding = 0
        self.first_bit = True
        self.bits_out = 0
        self.bins = 0

    def _put(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self.bw.u(b, 1)
        while self.outstanding > 0:
            self.bw.u(1 - b, 1)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.rng < 256:
            self.bits_out += 1
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.rng <<= 1
            self.low <<= 1

    def decision(self, ctx: np.ndarray, idx: int, binval: int) -> None:
        self.bins += 1
        row = ctx[idx]
        state = int(row[0])
        mps = int(row[1])
        r_lps = RANGE_LPS[state][(self.rng >> 6) & 3]
        self.rng -= r_lps
        if binval != mps:
            self.low += self.rng
            self.rng = r_lps
            if state == 0:
                row[1] = 1 - mps
            row[0] = NEXT_STATE_LPS[state]
        else:
            row[0] = NEXT_STATE_MPS[state]
        self._renorm()

    def bypass(self, binval: int) -> None:
        self.bins += 1
        self.bits_out += 1
        self.low <<= 1
        if binval:
            self.low += self.rng
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def terminate(self, binval: int) -> None:
        self.bins += 1
        self.rng -= 2
        if binval:
            self.low += self.rng
            self._flush()
        else:
            self._renorm()

    def _flush(self) -> None:
        self.rng = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self.bw.u(((self.low >> 7) & 3) | 1, 2)
        self.bits_out += 3

    # ---- composite binarizations -------------------------------------

    def unary(self, ctx, first_idx, rest_idx, value: int) -> None:
        if value == 0:
            self.decision(ctx, first_idx, 0)
            return
        self.decision(ctx, first_idx, 1)
        for _ in range(value - 1):
            self.decision(ctx, rest_idx, 1)
        self.decision(ctx, rest_idx, 0)

    def unary_max(self, ctx, first_idx, rest_idx, value, max_symbol) -> None:
        if value == 0:
            self.decision(ctx, first_idx, 0)
            return
        self.decision(ctx, first_idx, 1)
        if max_symbol == 0:
            return
        for _ in range(value - 1):
            self.decision(ctx, rest_idx, 1)
        if value < max_symbol + 1:
            self.decision(ctx, rest_idx, 0)

    def exp_golomb_eq_prob(self, value: int, k: int) -> None:
        while value >= (1 << k):
            self.bypass(1)
            value -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((value >> k) & 1)

    def ueg0_level(self, ctx, idx, value: int) -> None:
        """Inverse of CabacEngine.ueg0_level."""
        if value == 0:
            self.decision(ctx, idx, 0)
            return
        self.decision(ctx, idx, 1)
        if value < 13:
            for _ in range(value - 1):
                self.decision(ctx, idx, 1)
            self.decision(ctx, idx, 0)
        else:
            for _ in range(12):
                self.decision(ctx, idx, 1)
            self.exp_golomb_eq_prob(value - 13, 0)

    def ueg3_mv(self, ctx, base_idx, value: int, max_bin=3) -> None:
        """Inverse of CabacEngine.ueg3_mv: truncated unary (7 bins after
        the first) and the Exp-Golomb order-3 bypass escape."""
        if value == 0:
            self.decision(ctx, base_idx, 0)
            return
        self.decision(ctx, base_idx, 1)
        idx = base_idx + 1
        binno = 1
        escape = value >= 8
        for i in range(1, min(value, 7) + 1):
            self.decision(ctx, idx, 1 if (i < value or escape) else 0)
            binno += 1
            if binno == 2:
                idx += 1
            if binno == max_bin:
                idx += 1
        if escape:
            self.exp_golomb_eq_prob(value - 8, 3)
