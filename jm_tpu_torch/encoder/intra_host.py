"""Serial host intra encoder of an I picture (twin of jm_tpu/encoder/
encoder.py _FrameEncoder._encode_intra_mb, :2639-2689, for 4:2:0 and
4:2:2 frame pictures and 4:2:0 field pictures (the field scan), flat or
with the custom quant of encoder/qmatrix.QuantCtx, with its RD tools:
rdo, the trellis, I_PCM).

jm_tpu codes an I picture on the device (ops/intra.i_frame_step) only
when it is one slice of the device pipeline without custom quant, the
8x8 transform, rdo or I_PCM; otherwise each MB is coded on the host in
slice order, one after the other, because its intra prediction may read
only the MBs of its own slice coded before it. Per MB:
  - with enable_ipcm 2, I_PCM;
  - with rdo, the MB is coded as Intra4x4 (each block's mode by RD) and
    as Intra16x16, each with its chroma, and the one of least J = SSD +
    lambda_mode times its bits (rdo.count_mb_bits; with CABAC the
    slice's running engine) kept, Intra4x4 on a tie; with enable_ipcm 1
    I_PCM then replaces it when its J is lower;
  - else the best-SAD Intra16x16 mode is found, the MB coded as Intra4x4
    (each block's mode by SAD plus lambda_mode4 off the most probable
    mode), and Intra16x16 replaces it when its SAD plus 24 lambda_me is
    below the Intra4x4 cost; then the chroma mode and residual.
The Intra4x4, Intra16x16, I_PCM and chroma coding are
encoder/p_intra.py's IntraMBCoder (its Intra4x4 MB in the native
runtime without rdo, the trellis or custom quant); the predictors are
decoder/intra_pred.py's. jm_tpu's encoder has no Intra8x8: an I_NxN MB
is always 4x4.
"""

from __future__ import annotations

import numpy as np

from ..common.types import SliceType
from .p_intra import IntraMBCoder
from .rdo import MBState, lambda_mode, mb_ssd


class IntraPicture(IntraMBCoder):
    """One I picture coded MB by MB on the host: ``pic`` (PictureData)
    and the undeblocked recon planes recY / recU / recV (numpy uint8)."""

    stype = SliceType.I

    def __init__(self, orig, qp: int, qpc: int, lam: int, lam4: int,
                 slices, qctx=None, ar_period: int = 0, rd=None,
                 parity=None):
        """orig: the source (Y, U, V) uint8 planes; lam / lam4:
        lambda_me and lambda_mode4 of qp; slices: the slice plan, MB
        address lists in decode order; qctx / ar_period: the custom quant
        and its adaptive-rounding period; rd: the RD tools (rdo.RDOptions;
        IntraMBCoder); parity: a field picture's (0 top, 1 bottom; the
        field scan), None for a frame picture."""
        self._init_picture(orig, qp, qpc)
        self.set_parity(parity)
        self.lam, self.lam4 = lam, lam4
        self.qctx, self.ar_period = qctx, ar_period
        if rd is not None:
            self.rd = rd
        self.recY = np.zeros_like(self.origY)
        self.recU = np.zeros_like(self.origU)
        self.recV = np.zeros_like(self.origV)
        self._code_slices(slices, self._encode_intra_mb)

    def _encode_intra_mb(self, addr: int) -> None:
        pic, rd = self.pic, self.rd
        origY_mb = self._mb_orig(addr)[0]
        if rd.enable_ipcm >= 2:
            self._commit_ipcm(addr)
            return
        if rd.rdo:
            self._intra_mb_rd(addr, origY_mb)
            return
        cost16, mode16, pred16 = self._eval_i16(addr, origY_mb)
        save = _MBSnapshot(self, addr)
        cost4, cbp_luma = self._encode_i4_mb(addr, origY_mb)
        if cost16 + 24 * self.lam < cost4:
            save.restore()
            pic.i4_modes[addr] = -1
            cbp_luma = self._encode_i16(addr, origY_mb, mode16, pred16)
        cbp_chroma = self._encode_chroma_intra(addr)
        pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma

    def _intra_mb_rd(self, addr: int, origY_mb) -> None:
        """The RD decision of an intra MB (jm_tpu :2645-2676): Intra4x4
        and Intra16x16 each coded in full from the same state, then with
        enable_ipcm I_PCM; the least J = SSD + lambda_mode (0.57 with the
        trellis on) times the MB's bits, Intra4x4 on a tie with
        Intra16x16, the earlier coding on a tie with I_PCM."""
        pic = self.pic
        lam = lambda_mode(self.qp, intra_rdoq=self._rdoq_on)
        base = MBState(self, addr)
        _c, cbp_luma4 = self._encode_i4_mb(addr, origY_mb)
        pic.cbp[addr] = (self._encode_chroma_intra(addr) << 4) | cbp_luma4
        j4 = mb_ssd(self, addr) + lam * self._mb_bits(addr)
        s4 = MBState(self, addr)
        base.restore()
        _c16, m16, p16 = self._eval_i16(addr, origY_mb)
        pic.i4_modes[addr] = -1
        cbp_luma = self._encode_i16(addr, origY_mb, m16, p16)
        pic.cbp[addr] = (self._encode_chroma_intra(addr) << 4) | cbp_luma
        j16 = mb_ssd(self, addr) + lam * self._mb_bits(addr)
        if j4 <= j16:
            s4.restore()
        if self.rd.enable_ipcm:
            j_best = min(j4, j16)
            s_best = MBState(self, addr)
            base.restore()
            self._commit_ipcm(addr)
            j_pcm = mb_ssd(self, addr) + lam * self._mb_bits(addr)
            if j_pcm >= j_best:
                s_best.restore()
        pic.qp[addr] = self.qp


class _MBSnapshot:
    """What an Intra4x4 trial changes of an MB before Intra16x16 replaces
    it (jm_tpu _MBSnapshot, encoder.py:3528): its luma recon, luma levels
    and nnz, Intra4x4 modes and class, and the adaptive-rounding adjust
    it accumulated."""

    def __init__(self, coder: IntraMBCoder, addr: int):
        self.coder, self.addr = coder, addr
        self.py, self.px = (addr // coder.mb_w) * 16, (addr % coder.mb_w) * 16
        pic = coder.pic
        self.recY = coder.recY[self.py:self.py + 16,
                               self.px:self.px + 16].copy()
        self.coef = pic.luma_coef[addr].copy()
        self.nnz = pic.luma_nnz[addr].copy()
        self.modes = pic.i4_modes[addr].copy()
        self.cls = pic.mb_class[addr]
        self.ar = coder.qctx.ar_snapshot() if coder.qctx is not None \
            else None

    def restore(self) -> None:
        coder, addr, pic = self.coder, self.addr, self.coder.pic
        coder.recY[self.py:self.py + 16, self.px:self.px + 16] = self.recY
        pic.luma_coef[addr] = self.coef
        pic.luma_nnz[addr] = self.nnz
        pic.i4_modes[addr] = self.modes
        pic.mb_class[addr] = self.cls
        if self.ar is not None:
            self.coder.qctx.ar_restore(self.ar)
