"""Serial host intra encoder of an I picture (twin of
the non-RDO branch of jm_tpu/encoder/encoder.py _FrameEncoder
._encode_intra_mb, :2639-2689, with its _encode_i4_mb, :2407-2505, and
_blk_avail, :2507-2522, for 4:2:0 without trellis, flat or with the
custom quant of encoder/qmatrix.QuantCtx).

jm_tpu codes an I picture on the device (ops/intra.i_frame_step) only
when it is one slice of the device pipeline without custom quant or the
8x8 transform; otherwise each MB is coded on the host in slice order,
one after the other, because its intra prediction may read only the MBs
of its own slice coded before it. Per MB: the best-SAD Intra16x16 mode
is found first, then the MB is coded as Intra4x4 (each 4x4 block's mode
by SAD plus 4 lambda_me off the most probable mode, coded and
reconstructed before the next block); Intra16x16 replaces it when its
SAD plus 24 lambda_me is below the Intra4x4 cost. Then the chroma mode
and residual. The Intra16x16 and chroma coding are encoder/p_intra.py's
IntraMBCoder; the predictors are decoder/intra_pred.py's.

jm_tpu restores an _MBSnapshot of the MB before coding Intra16x16 over a
losing Intra4x4 trial; here only the adaptive-rounding adjust that the
trial accumulated is restored: Intra16x16 writes every field and recon
sample that the trial wrote (mb_class, luma_coef, luma_nnz, the MB's luma
recon) and i4_modes is reset, which leaves the same state. jm_tpu's
encoder has no Intra8x8: an I_NxN MB is always 4x4.
"""

from __future__ import annotations

import numpy as np

from ..common.picture import MB_I4
from ..common.predict_ctx import CODE2RASTER, RASTER2CODE
from ..decoder import intra_pred as IP
from . import residual_np as RN
from .p_intra import IntraMBCoder


class IntraPicture(IntraMBCoder):
    """One I picture coded MB by MB on the host: ``pic`` (PictureData)
    and the undeblocked recon planes recY / recU / recV (numpy uint8)."""

    def __init__(self, orig, qp: int, qpc: int, lam: int, lam4: int,
                 slices, qctx=None, ar_period: int = 0):
        """orig: the source (Y, U, V) uint8 planes; lam / lam4:
        lambda_me and lambda_mode4 of qp; slices: the slice plan, MB
        address lists in decode order; qctx / ar_period: the custom quant
        and its adaptive-rounding period (IntraMBCoder)."""
        self._init_picture(orig, qp, qpc)
        self.lam, self.lam4 = lam, lam4
        self.qctx, self.ar_period = qctx, ar_period
        self.recY = np.zeros_like(self.origY)
        self.recU = np.zeros_like(self.origU)
        self.recV = np.zeros_like(self.origV)
        self._code_slices(slices, self._encode_intra_mb)

    def _encode_intra_mb(self, addr: int) -> None:
        pic = self.pic
        origY_mb = self._mb_orig(addr)[0]
        cost16, mode16, pred16 = self._eval_i16(addr, origY_mb)
        ar = self.qctx.ar_snapshot() if self.qctx is not None else None
        cost4, cbp_luma = self._encode_i4_mb(addr, origY_mb)
        if cost16 + 24 * self.lam < cost4:
            if ar is not None:
                self.qctx.ar_restore(ar)
            pic.i4_modes[addr] = -1
            cbp_luma = self._encode_i16(addr, origY_mb, mode16, pred16)
        cbp_chroma = self._encode_chroma_intra(addr)
        pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma

    def _blk_avail(self, addr: int, gx: int, gy: int, code: int):
        """(left, top, top-left, top-right) availability of the 4x4 block
        at block coordinates (gx, gy), the code-th of MB addr."""

        def ok(nx, ny):
            if nx < 0 or ny < 0 or nx >= self.mb_w * 4:
                return False
            naddr = (ny // 4) * self.mb_w + (nx // 4)
            if naddr == addr:
                return RASTER2CODE[(ny % 4) * 4 + (nx % 4)] < code
            if naddr > addr:
                return False
            return self.pctx.avail(naddr, addr)
        return (ok(gx - 1, gy), ok(gx, gy - 1), ok(gx - 1, gy - 1),
                ok(gx + 1, gy - 1))

    def _encode_i4_mb(self, addr: int, origY_mb):
        """Code MB addr as Intra4x4, block after block; returns (the sum
        of the chosen modes' costs, cbp_luma)."""
        pic, qp, Y = self.pic, self.qp, self.recY
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        pic.mb_class[addr] = MB_I4
        total_cost = 0
        coded_quads = set()
        for code in range(16):
            blk = int(CODE2RASTER[code])
            by, bx = divmod(blk, 4)
            gx, gy = mbx * 4 + bx, mby * 4 + by
            x, y = gx * 4, gy * 4
            avail_l, avail_t, avail_tl, avail_tr = self._blk_avail(
                addr, gx, gy, code)
            top = np.zeros(8, np.int32)
            left = np.zeros(4, np.int32)
            corner = 0
            if avail_t:
                top[0:4] = Y[y - 1, x:x + 4]
                top[4:8] = Y[y - 1, x + 4:x + 8] if avail_tr \
                    else Y[y - 1, x + 3]
            if avail_l:
                left[:] = Y[y:y + 4, x - 1]
            if avail_tl:
                corner = int(Y[y - 1, x - 1])
            mpm = self.pctx.pred_intra4_mode(addr, blk)
            o = origY_mb[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] \
                .astype(np.int32)
            cand = [IP.I4_DC]
            if avail_t:
                cand += [IP.I4_VERT, IP.I4_VL, IP.I4_DDL]
            if avail_l:
                cand += [IP.I4_HOR, IP.I4_HU]
            if avail_t and avail_l and avail_tl:
                cand += [IP.I4_DDR, IP.I4_VR, IP.I4_HD]
            best = None
            for m in cand:
                pred = IP.predict_i4(m, top, left, corner, avail_t, avail_l)
                cost = int(np.abs(o - pred).sum())
                if m != mpm:
                    cost += self.lam4
                if best is None or cost < best[0]:
                    best = (cost, m, pred)
            cost, m, pred = best
            total_cost += cost
            pic.i4_modes[addr, blk] = m
            w = RN.np_forward4x4((o - pred)[None])[0]
            scan = RN.to_scan(self._q4(w[None], qp, True))[0]
            pic.luma_coef[addr, blk] = scan
            tc = int((scan != 0).sum())
            pic.luma_nnz[addr, blk] = tc
            if tc:
                coded_quads.add((by // 2) * 2 + bx // 2)
            Y[y:y + 4, x:x + 4] = RN.recon_luma_4x4(
                pred[None], scan[None], qp, tab=self._itab4(True))[0]
        return total_cost, sum(1 << q for q in coded_quads)
