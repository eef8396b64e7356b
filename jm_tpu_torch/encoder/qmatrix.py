"""Custom quantization of the host coders: scaling matrices, explicit
quant offsets and adaptive rounding, and the readers of lencod's
QmatrixFile / QOffsetMatrixFile (``parse_matrix_cfg`` /
``parse_offset_cfg``, q_matrix.c:252-489); the port's own copy of
jm_tpu/encoder/qmatrix.py (lencod q_matrix.c CalculateQuant4x4Param /
CalculateQuant8x8Param, q_offsets.c, q_around.c).

Forward ScaleComp = (quant_coef << 4) / ScalingList, inverse
InvScaleComp = dequant_coef * ScalingList; OffsetComp = offset << (Q_BITS
+ qp / 6 - OffsetBits), OffsetBits = 11. Adaptive rounding (JVT-N011)
accumulates, over the blocks a macroblock quantizes, fadjust =
rshift_rnd_sf(W * (scaled - (level << qbits)), qbits + 1) of every
nonzero level into the offset lists (clipped to [0, 1 << 10]) when the
MB is committed, and the quantizers read a copy of the lists refreshed
every AdaptRndPeriod MBs of a slice (slice.c:488). The lists carry from
picture to picture.

Matrices are given in raster order; the SPS / PPS carry them in zig-zag
order (``to_zigzag4`` / ``to_zigzag8``, ``write_scaling_list``). Only
the 15 4x4 and 5 luma 8x8 offset categories of 4:2:0 are kept.
"""

from __future__ import annotations

import re

import numpy as np

from ..common.tables import (DEQUANT_SCALE_4x4, DEQUANT_SCALE_8x8,
                             QUANT_SCALE_4x4, QUANT_SCALE_8x8, ZIGZAG_4x4,
                             ZIGZAG_8x8)
from ..decoder.parset import (DEFAULT_4x4_INTER, DEFAULT_4x4_INTRA,
                              DEFAULT_8x8_INTER, DEFAULT_8x8_INTRA)

_ZZ4 = np.asarray(ZIGZAG_4x4)
_ZZ8 = np.asarray(ZIGZAG_8x8)

OFFSET_BITS = 11                     # q_offsets.h:18
OFFSET_RANGE = 1 << (OFFSET_BITS - 1)

MATRIX4_NAMES = ("INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
                 "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV")
MATRIX8_NAMES = ("INTRA8X8_LUMA", "INTER8X8_LUMA")

# q_offsets.c:24 OffsetType4x4 (the first 15; the rest are 4:4:4's)
OFFSET4_NAMES = (
    "INTRA4X4_LUMA_INTRA", "INTRA4X4_CHROMAU_INTRA", "INTRA4X4_CHROMAV_INTRA",
    "INTRA4X4_LUMA_INTERP", "INTRA4X4_CHROMAU_INTERP",
    "INTRA4X4_CHROMAV_INTERP",
    "INTRA4X4_LUMA_INTERB", "INTRA4X4_CHROMAU_INTERB",
    "INTRA4X4_CHROMAV_INTERB",
    "INTER4X4_LUMA_INTERP", "INTER4X4_CHROMAU_INTERP",
    "INTER4X4_CHROMAV_INTERP",
    "INTER4X4_LUMA_INTERB", "INTER4X4_CHROMAU_INTERB",
    "INTER4X4_CHROMAV_INTERB")
# q_offsets.c:42 OffsetType8x8 (the luma rows)
OFFSET8_NAMES = ("INTRA8X8_LUMA_INTRA", "INTRA8X8_LUMA_INTERP",
                 "INTRA8X8_LUMA_INTERB", "INTER8X8_LUMA_INTERP",
                 "INTER8X8_LUMA_INTERB")

# the default offsets (q_offsets.c:135-208): intra 682 (~1/3), inter 342
# (~1/6), in units of 1 / 2048
_OFF_INTRA = 682
_OFF_INTER = 342


def default_offsets():
    """(off4 (15, 16), off8 (5, 64)) int32: the default offset lists
    (InitOffsetParam, q_offsets.c:546-568). The 4x4 rows: intra blocks of
    I, P and B slices (Y, Cb, Cr each), then inter blocks of P and of B
    slices; the 8x8 rows: intra of I, P, B, inter of P, B."""
    off4 = np.empty((15, 16), np.int32)
    off4[:9] = _OFF_INTRA
    off4[9:] = _OFF_INTER
    off8 = np.empty((5, 64), np.int32)
    off8[:3] = _OFF_INTRA
    off8[3:] = _OFF_INTER
    return off4, off8


def _parse_sections(text: str, names, size: int) -> dict:
    """The matrix-file tokens (q_matrix.c:300-380): NAME = v, v, v ...,
    values split by commas or whitespace, '#' comments; the first full
    section of a name counts."""
    body = "\n".join(ln.split("#", 1)[0] for ln in text.splitlines())
    out = {}
    for m in re.finditer(r"([A-Z0-9_]+)\s*=", body):
        name = m.group(1)
        if name not in names or name in out:
            continue
        tail = body[m.end():]
        nxt = re.search(r"[A-Z0-9_]{4,}\s*=", tail)
        seg = tail[:nxt.start()] if nxt else tail
        vals = [int(v) for v in re.findall(r"-?\d+", seg)][:size]
        if len(vals) == size:
            out[name] = vals
    return out


def parse_matrix_cfg(text: str):
    """QmatrixFile -> (the 6 raster 4x4 lists, the 2 raster 8x8 lists);
    a missing list, or one whose first value is 0, is the default one
    (q_matrix.c:433); values clipped to 1..255."""
    sec = _parse_sections(text, set(MATRIX4_NAMES), 16)
    sec8 = _parse_sections(text, set(MATRIX8_NAMES), 64)
    l4 = []
    for i, nm in enumerate(MATRIX4_NAMES):
        v = sec.get(nm)
        if v is None or v[0] == 0:
            l4.append(from_zigzag4(DEFAULT_4x4_INTRA if i < 3
                                   else DEFAULT_4x4_INTER))
        else:
            l4.append([min(255, max(1, x)) for x in v])
    l8 = []
    for i, nm in enumerate(MATRIX8_NAMES):
        v = sec8.get(nm)
        if v is None or v[0] == 0:
            l8.append(from_zigzag8(DEFAULT_8x8_INTRA if i == 0
                                   else DEFAULT_8x8_INTER))
        else:
            l8.append([min(255, max(1, x)) for x in v])
    return l4, l8


def parse_offset_cfg(text: str):
    """QOffsetMatrixFile -> (off4 (15, 16), off8 (5, 64)) raster int32,
    the default lists where a section is missing."""
    off4, off8 = default_offsets()
    sec = _parse_sections(text, set(OFFSET4_NAMES), 16)
    for k, nm in enumerate(OFFSET4_NAMES):
        if nm in sec:
            off4[k] = sec[nm]
    sec8 = _parse_sections(text, set(OFFSET8_NAMES), 64)
    for k, nm in enumerate(OFFSET8_NAMES):
        if nm in sec8:
            off8[k] = sec8[nm]
    return off4, off8


def to_zigzag4(raster16) -> list:
    return [raster16[i] for i in _ZZ4]


def to_zigzag8(raster64) -> list:
    return [raster64[i] for i in _ZZ8]


def from_zigzag4(zz16) -> list:
    out = [0] * 16
    for k, pos in enumerate(_ZZ4):
        out[pos] = zz16[k]
    return out


def from_zigzag8(zz64) -> list:
    out = [0] * 64
    for k, pos in enumerate(_ZZ8):
        out[pos] = zz64[k]
    return out


def write_scaling_list(bw, lst_zz, size: int) -> None:
    """scaling_list() (spec 7.3.2.1.1.1): each entry of the zig-zag list
    as the se(v) delta from the one before (lencod parset.c
    Scaling_List)."""
    last = 8
    for j in range(size):
        nxt = int(lst_zz[j])
        delta = (nxt - last) % 256
        bw.se(delta - 256 if delta > 127 else delta)
        last = nxt


def _off4_row(slice_type: str, intra: bool, plane: int) -> int:
    """The 4x4 offset row of a block (q_offsets.c
    CalculateOffset4x4Param)."""
    if intra:
        return {"I": 0, "P": 3, "B": 6}[slice_type] + plane
    return (9 if slice_type != "B" else 12) + plane


def _off8_row(slice_type: str, intra: bool) -> int:
    if intra:
        return {"I": 0, "P": 1, "B": 2}[slice_type]
    return 3 if slice_type != "B" else 4


class QuantCtx:
    """The forward and inverse quant of one coded picture (quant4x4_normal,
    quant_dc4x4_normal, quant8x8_normal with ScaleComp / OffsetComp /
    InvScaleComp, and their _around variants). lists4 / lists8: the six
    4x4 and two 8x8 scaling matrices in raster order (flat 16s without a
    matrix); slice_type "I", "P" or "B"; off_state: the (off4, off8)
    offset lists, updated in place by adaptive rounding so that they carry
    to the next picture; ar_weight: AdaptRndWeight, 0 without adaptive
    rounding."""

    def __init__(self, lists4, lists8, slice_type: str, off_state=None,
                 ar_weight: int = 0):
        self.slice_type = slice_type
        self.ar_weight = ar_weight
        ws4 = [np.asarray(w, np.int64).reshape(4, 4) for w in lists4]
        ws8 = [np.asarray(w, np.int64).reshape(8, 8) for w in lists8]
        # forward (list, 6, n, n) ScaleComp; inverse (list, 52, n, n)
        self.scale4 = np.stack([(QUANT_SCALE_4x4.astype(np.int64) << 4) // w
                                for w in ws4])
        self.scale8 = np.stack([(QUANT_SCALE_8x8.astype(np.int64) << 4) // w
                                for w in ws8])
        qp6 = np.arange(52) % 6
        self.inv4 = np.stack([DEQUANT_SCALE_4x4[qp6] * w for w in ws4]) \
            .astype(np.int32)
        self.inv8 = np.stack([DEQUANT_SCALE_8x8[qp6] * w for w in ws8]) \
            .astype(np.int32)
        if off_state is None:
            off_state = default_offsets()
        self.off4, self.off8 = off_state
        # the quantizers read the active copy; the learned lists fold in
        # at AdaptRndPeriod boundaries only
        self.off4_active = self.off4.copy()
        self.off8_active = self.off8.copy()
        self._pending4 = np.zeros((15, 16), np.int64)
        self._pending8 = np.zeros((5, 64), np.int64)

    def maybe_refresh(self, mb_idx: int, period: int) -> None:
        """Before the mb_idx-th MB of a slice: every period MBs the
        active lists take the learned ones."""
        if self.ar_weight and period and mb_idx % period == 0:
            self.off4_active[:] = self.off4
            self.off8_active[:] = self.off8

    # ---- forward quant -----------------------------------------------------

    def _around(self, pending, row, aw, scaled, lev, qbits, n) -> None:
        """Accumulate the blocks' fadjust of the nonzero levels."""
        err = np.where(aw > 0, scaled - (lev << qbits), 0)
        adj = (self.ar_weight * err + (1 << qbits)) >> (qbits + 1)
        pending[row] += np.where(lev > 0, adj, 0).reshape(-1, n).sum(axis=0)

    def quant_4x4(self, w: np.ndarray, qp: int, plane: int,
                  intra: bool) -> np.ndarray:
        """(..., 4, 4) coefficients -> levels of plane 0 Y, 1 Cb, 2 Cr."""
        qbits = 15 + qp // 6
        sc = self.scale4[plane + (0 if intra else 3), qp % 6]
        row = _off4_row(self.slice_type, intra, plane)
        off = (self.off4_active[row].astype(np.int64)
               << (qbits - OFFSET_BITS)).reshape(4, 4)
        aw = np.abs(w.astype(np.int64))
        scaled = aw * sc
        lev = (scaled + off) >> qbits
        if self.ar_weight:
            self._around(self._pending4, row, aw, scaled, lev, qbits, 16)
        return (np.sign(w) * lev).astype(np.int32)

    def quant_dc(self, dc: np.ndarray, qp: int, plane: int,
                 intra: bool) -> np.ndarray:
        """DC levels after the Hadamard (luma 4x4 or chroma 2x2), with the
        [0, 0] scale and offset: (|c| sc + 2 f) >> (qbits + 1)."""
        qbits = 15 + qp // 6
        sc = int(self.scale4[plane + (0 if intra else 3), qp % 6, 0, 0])
        row = _off4_row(self.slice_type, intra, plane)
        f = int(self.off4_active[row, 0]) << (qbits - OFFSET_BITS)
        lev = (np.abs(dc.astype(np.int64)) * sc + 2 * f) >> (qbits + 1)
        return (np.sign(dc) * lev).astype(np.int32)

    def quant_8x8(self, w: np.ndarray, qp: int, intra: bool) -> np.ndarray:
        """(..., 8, 8) coefficients -> luma levels."""
        qbits = 16 + qp // 6
        sc = self.scale8[0 if intra else 1, qp % 6]
        row = _off8_row(self.slice_type, intra)
        off = (self.off8_active[row].astype(np.int64)
               << (qbits - OFFSET_BITS)).reshape(8, 8)
        aw = np.abs(w.astype(np.int64))
        scaled = aw * sc
        lev = (scaled + off) >> qbits
        if self.ar_weight:
            self._around(self._pending8, row, aw, scaled, lev, qbits, 64)
        return (np.sign(w) * lev).astype(np.int32)

    # ---- inverse tables of the recon ---------------------------------------

    def inv_tab4(self, plane: int, intra: bool) -> np.ndarray:
        return self.inv4[plane + (0 if intra else 3)]

    def inv_tab8(self, intra: bool) -> np.ndarray:
        return self.inv8[0 if intra else 1]

    # ---- adaptive rounding ---------------------------------------------------

    def ar_snapshot(self):
        return self._pending4.copy(), self._pending8.copy()

    def ar_restore(self, snap) -> None:
        self._pending4, self._pending8 = snap[0].copy(), snap[1].copy()

    def ar_commit_mb(self) -> None:
        """Fold the committed MB's fadjust into the offset lists (q_around.c
        update_offset_params)."""
        if not self.ar_weight:
            return
        np.clip(self.off4 + self._pending4, 0, OFFSET_RANGE, out=self.off4)
        np.clip(self.off8 + self._pending8, 0, OFFSET_RANGE, out=self.off8)
        self._pending4[:] = 0
        self._pending8[:] = 0
