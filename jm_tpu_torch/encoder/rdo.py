"""Rate-distortion tools of the host coders, twin of
jm_tpu/encoder/rdo.py: the SSD-domain lambda (lambda_mode), the snapshot
and restore of one MB's coding state (MBState: its PictureData rows and
recon), its reconstruction SSD (mb_ssd), the running CABAC engine of one
slice (CabacRate: exact marginal arithmetic-coded bits of a candidate,
lencod rdopt_coding_state.c store/reset_coding_state over a small
state), and the bit count of one decided MB (count_mb_bits: the CABAC
engine's marginal bits where a CabacRate is installed, else the Python
CAVLC MBWriter's, as jm_tpu counts them: a CABAC stream's MBs are
counted in CAVLC bits unless its RD tiers installed the engine).
RDOptions carries the RD fields of EncoderConfig into the host coders.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.bitwriter import BitWriter
from .syntax import MBWriter

# PictureData per-MB rows that a candidate trial may touch
_PIC_ROWS = ("mb_class", "skip", "transform8x8", "i4_modes", "i16_mode",
             "chroma_mode", "cbp", "qp", "luma_coef", "luma_dc",
             "chroma_dc", "chroma_coef", "luma_coef8", "luma_nnz",
             "chroma_nnz", "mv", "ref_idx", "sub_mode", "mvd", "cbp_bits",
             "mv_l1", "ref_idx_l1", "pdir", "ref_pic_id", "ref_pic_id_l1",
             "b_direct", "inter_mode")


@dataclass
class RDOptions:
    """The RD fields of one coding (EncoderConfig's names): the mode
    decision tier rdo (0 cost-based, 1 md_high, 2 md_highfast, 3
    md_highloss, 4 md_high_updated), the trellis (rdoq) and its luma DC,
    chroma AC and chroma DC flags, enable_ipcm (1 an RD candidate, 2
    forced), whether the stream is CABAC, the SPS / PPS the bit counts
    serialize under, and the simulated lossy decoders of rdo 3
    (encoder/errdo.ErrdoState or None)."""
    rdo: int = 0
    rdoq: int = 0
    rdoq_dc: int = 0
    rdoq_cr: int = 0
    rdoq_dc_cr: int = 0
    enable_ipcm: int = 0
    cabac: bool = False
    sps: object = None
    pps: object = None
    errdo: object = None


def lambda_mode(qp: int, intra_rdoq: bool = False) -> float:
    """SSD-domain Lagrange multiplier (lencod lambda.c
    get_implicit_lambda_p_slice): 0.85 * 2^((QP-12)/3), with 0.57 in
    place of 0.85 in I slices while the trellis is on (lambda.c:199,
    247)."""
    f = 0.57 if intra_rdoq else 0.85
    return f * 2.0 ** ((qp - 12) / 3.0)


class MBState:
    """Snapshot of one MB's coding state: its PictureData rows and its
    recon samples in the coder's planes."""

    def __init__(self, coder, addr: int):
        self.coder = coder
        self.addr = addr
        mbx, mby = addr % coder.mb_w, addr // coder.mb_w
        self.px, self.py = mbx * 16, mby * 16
        pic = coder.pic
        self.rows = {k: getattr(pic, k)[addr].copy() for k in _PIC_ROWS}
        self.recY = coder.recY[self.py:self.py + 16,
                               self.px:self.px + 16].copy()
        self._csl = coder._csl(addr)          # the MB's chroma block
        self.recU = coder.recU[self._csl].copy()
        self.recV = coder.recV[self._csl].copy()

    def restore(self) -> None:
        coder, addr = self.coder, self.addr
        pic = coder.pic
        for k, v in self.rows.items():
            getattr(pic, k)[addr] = v
        coder.recY[self.py:self.py + 16, self.px:self.px + 16] = self.recY
        coder.recU[self._csl] = self.recU
        coder.recV[self._csl] = self.recV


def mb_ssd(coder, addr: int) -> int:
    """Reconstruction SSD over Y + U + V of one MB (its chroma 8x8, or
    8x16 at 4:2:2)."""
    mbx, mby = addr % coder.mb_w, addr // coder.mb_w
    px, py = mbx * 16, mby * 16
    oY, oU, oV = coder._mb_orig(addr)
    csl = coder._csl(addr)
    dy = oY.astype(np.int64) - coder.recY[py:py + 16, px:px + 16]
    du = oU.astype(np.int64) - coder.recU[csl]
    dv = oV.astype(np.int64) - coder.recV[csl]
    return int((dy * dy).sum() + (du * du).sum() + (dv * dv).sum())


def count_mb_bits(pic, sps, pps, qp: int, addr: int, slice_type,
                  num_ref: int, cabac_rate=None) -> int:
    """The bits of MB addr of pic (PictureData) in a slice of slice_type
    whose running QP is qp, with num_ref active list-0 references: the
    marginal arithmetic-coded bits of cabac_rate's engine where one is
    given, else the Python CAVLC MBWriter's (a skipped MB costs the skip
    run it leaves)."""
    if cabac_rate is not None:
        return cabac_rate.mb_bits(addr)
    bw = BitWriter()
    w = MBWriter(bw, pic, sps, pps, qp)
    w.write_mb(addr, slice_type, num_ref)
    w.finish(slice_type)
    return bw.bitpos


class CabacRate:
    """The running CABAC engine and contexts of one slice of a host
    coding (jm_tpu rdo.CabacRate): MBs are committed into it in slice
    order as they are decided, so a candidate's marginal bits (mb_bits)
    are the bits the serializer will spend on it. The engine and
    contexts start from the coder's QP when the slice starts."""

    def __init__(self, coder, slice_type, cabac_init_idc: int = 0):
        from .syntax_cabac import MBWriterCABAC
        rd = coder.rd
        self.bw = BitWriter()
        self.w = MBWriterCABAC(self.bw, coder.pic, slice_type, coder.qp,
                               cabac_init_idc, num_ref=coder.num_ref,
                               t8_mode=bool(rd.pps.transform_8x8_mode_flag))
        self._ctx_keys = [k for k, v in vars(self.w.ctxs).items()
                          if isinstance(v, np.ndarray)]

    def snapshot(self):
        w, eng, bw = self.w, self.w.eng, self.bw
        return (eng, eng.low, eng.rng, eng.outstanding, eng.first_bit,
                eng.bits_out, len(bw.buf), bw.acc, bw.nacc, w.last_dquant,
                {k: getattr(w.ctxs, k).copy() for k in self._ctx_keys})

    def restore(self, s) -> None:
        """Back to snapshot s, the engine object included (an I_PCM MB
        restarts the engine)."""
        (eng, low, rng, outstanding, first_bit, bits_out, nbuf, acc, nacc,
         last_dquant, ctxs) = s
        self.w.eng = eng
        eng.low, eng.rng = low, rng
        eng.outstanding, eng.first_bit = outstanding, first_bit
        eng.bits_out = bits_out
        del self.bw.buf[nbuf:]
        self.bw.acc, self.bw.nacc = acc, nacc
        for k, v in ctxs.items():
            getattr(self.w.ctxs, k)[...] = v
        self.w.last_dquant = last_dquant

    def mb_bits(self, addr: int) -> int:
        """The marginal CABAC bits of the MB staged in the picture (the
        engine and contexts rolled back afterwards)."""
        s = self.snapshot()
        b0 = self.w.eng.bits_out
        self.w.write_mb(addr)
        bits = self.w.eng.bits_out - b0
        self.restore(s)
        return bits

    def commit(self, addr: int) -> None:
        """Advance the running engine past the decided MB."""
        self.w.write_mb(addr)
        self.w.eng.terminate(0)
