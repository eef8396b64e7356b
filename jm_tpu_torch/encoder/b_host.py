"""The B macroblock coder of the port: twin of jm_tpu/encoder/encoder.py
_FrameEncoder._encode_b_mb (:3418-3528) with _b_pred_assemble (:3360),
_mc_blk_b (:3351), _mc_chroma (:3326), _commit_inter_residual (:3409)
and _code_luma_inter (:3114), for 4:2:0 frame pictures with one
reference per list, flat quant or the custom quant of
encoder/qmatrix.QuantCtx, the 4x4 or the adaptive 8x8 transform, the
trellis (rdoq: the 4x4 blocks, and the 8x8 blocks in CABAC, while the
coder's IntraMBCoder._rdoq_on holds) and forced I_PCM (enable_ipcm 2).
InterMBCoder holds the motion compensation and the inter residual that
the P macroblock coder (encoder/p_host.py) shares, with a field
picture's chroma offset for reference fields of the other parity.

Per MB, in slice order (serial host code, as in jm_tpu):
  - spatial direct: its motion (decoder/b_slice.py) and its prediction,
    SAD + lambda;
  - the best 16x16 list-0 and list-1 MVs: the integer full search over
    the SAD table made on the device (ops/enc.full_search_sad16) plus
    lambda-weighted mvd bits, with the spiral tie-break, or each list's
    EPZS / UMHex searcher (encoder/me_epzs.py), then the half- /
    quarter-pel SATD (or SAD) refinement, + 3 lambda each;
  - the average of the two (bi-prediction), SAD + lambda * (5 + mvd
    bits of both);
  - the cheapest of the four, unless Intra16x16's SAD + 2 lambda_mode4
    is below it (encoder/p_intra.py's IntraMBCoder codes it);
then the inter residual (4x4 luma with JM's coefficient thresholding;
with transform8x8 also the 8x8 transform, kept by SSD + lambda_mode4
per level; 4:2:0 chroma) and the recon. A direct MB without
coefficients becomes B_Skip. The predictions are made per 4x4 block,
each list's luma at quarter-pel and chroma at eighth-pel, the two
averaged as (p0 + p1 + 1) >> 1, or with weighted bi-prediction (wp, the
decoder's WPParams) weighted as a decoder does: what a decoder
reconstructs. As in jm_tpu, only the direct candidate's cost and the
coded prediction are weighted; the searches and the bi candidate's cost
are not.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native as N
from ..common.picture import MB_I16, MB_INTER
from ..common.predict_ctx import CODE2RASTER
from ..common.types import SliceType
from ..decoder import b_slice as B
from . import me as ME
from . import rdoq as RQ
from . import residual_np as RN
from .p_intra import IntraMBCoder


@dataclass
class HostRef:
    """A reference picture's state on the host: the quarter-pel planes
    (4, H + 2 PAD, W + 2 PAD), the padded chroma, and its uid."""
    planes: np.ndarray
    padU: np.ndarray
    padV: np.ndarray
    uid: int
    parity: int | None = None       # a reference field's, else None


class InterMBCoder(IntraMBCoder):
    """The inter side of a host MB coder: a reference's 4x4 motion
    compensation and the inter residual, over the IntraMBCoder state (and
    w / h, the picture's luma size; transform8x8: the PPS's
    transform_8x8_mode_flag). ``native_me``: the integer full search's
    arg-min, the fractional refinement and the 4x4 blocks' motion
    compensation by the native runtime (jm_enc.cpp int_search,
    subpel_refine, mc_blk); False: their numpy twins in encoder/me.py,
    which give the same MVs, costs and predictions."""

    transform8x8 = False
    native_me = True

    def _int_mv(self, table, cols, pred_mv):
        """The integer MV of least SAD (table's columns cols summed: one
        MB's row of a full-search table, (2 sr + 1)^2 displacements) plus
        lambda-weighted mvd bits against pred_mv, with the spiral
        tie-break."""
        if self.native_me:
            return np.array(N.load().int_search(
                table, cols, (int(pred_mv[0]), int(pred_mv[1]), self.sr),
                int(self.lam)), np.int32)
        csum = ((table if table.ndim == 1 else table[:, list(cols)])
                .astype(np.int64).reshape(len(table), -1).sum(axis=1)
                + ME.int_rate_tab(pred_mv, self.sr, self.lam))
        return ME.best_int_mv_tiebreak(
            csum, ME.spiral_rank_tab(pred_mv, self.sr), self.sr)

    def _subpel(self, orig_blk, ref: HostRef, px: int, py: int, mv,
                pred_mv, extra_bits: int = 0, qpel_start: bool = False):
        """encoder/me.py subpel_refine of one block (orig_blk, at luma
        (px, py)) around mv on ref: (quarter-pel MV, cost)."""
        if not (self.native_me and ref.planes.dtype == np.uint8
                and orig_blk.dtype == np.uint8):
            return ME.subpel_refine(orig_blk, ref.planes, px, py, mv, self.w,
                                    self.h, pred_mv, self.lam,
                                    extra_bits=extra_bits,
                                    use_satd=self.satd,
                                    qpel_start=qpel_start)
        mx, my, cost = N.load().subpel_refine(
            orig_blk, ref.planes,
            (px, py, int(mv[0]), int(mv[1]), self.w, self.h,
             int(pred_mv[0]), int(pred_mv[1]), int(extra_bits),
             int(bool(self.satd)), int(qpel_start)), int(self.lam))
        return np.array([mx, my], np.int32), cost

    def _mc_blk(self, ref: HostRef, px, py, bx, by, mv):
        """One 4x4 luma block and its chroma blocks from one reference
        (the decoder's per-4x4 motion compensation): 2x2 at 4:2:0; 2 wide
        and 4 tall at 4:2:2, where the vertical chroma displacement is the
        luma MV in quarter samples (jm_tpu _mc_chroma, encoder.py:3326).
        In a field picture a reference field of the other parity moves
        the 4:2:0 chroma vector by -2 (top field) or +2 (bottom) quarter
        samples (spec 8.4.1.4; jm_tpu encoder.py:3331-3339)."""
        mvx, mvy = int(mv[0]), int(mv[1])
        x4, y4 = (px + bx * 4) * 4 + mvx, (py + by * 4) * 4 + mvy
        cx8 = (px // 2 + bx * 2) * 8 + mvx
        if self.crows == 2:
            cy8 = (py // 2 + by * 2) * 8 + mvy
            if self.cur_parity is not None and ref.parity is not None \
                    and ref.parity != self.cur_parity:
                cy8 += -2 if self.cur_parity == 0 else 2
        else:
            cy8 = (py + by * 4) * 8 + 2 * mvy
        cw, ch, cbh = self.w // 2, self.ch * self.mb_h, self.crows
        if self.native_me and ref.planes.dtype == np.uint8:
            out = (np.empty((4, 4), np.int32), np.empty((cbh, 2), np.int32),
                   np.empty((cbh, 2), np.int32))
            N.load().mc_blk(ref.planes, ref.padU, ref.padV,
                            (x4, y4, 4, 4, self.w, self.h, cx8, cy8, 2, cbh,
                             cw, ch), *out)
            return out
        return (ME.mc_luma_block(ref.planes, x4, y4, 4, 4, self.w, self.h),
                ME.mc_chroma_block(ref.padU, cx8, cy8, 2, cbh, cw, ch),
                ME.mc_chroma_block(ref.padV, cx8, cy8, 2, cbh, cw, ch))

    # ---- residual ---------------------------------------------------------

    def _code_luma_inter(self, addr, o, pred_y) -> int:
        """The inter luma residual (4x4 transform, JM's thresholding of
        cheap 8x8 quadrants and MBs, macroblock.c:901,1248; with
        transform8x8 and no partition below 8x8 also the 8x8 transform
        with its own thresholds, kept when its SSD + lambda_mode4 per
        nonzero level is below the 4x4's): commits the levels, nnz and
        recon; returns cbp_luma."""
        pic = self.pic
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        res = o.astype(np.int64) - pred_y
        w4 = RN.np_forward4x4(res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
                              .reshape(16, 4, 4))
        rdoq = self._rdoq_on
        if rdoq:
            # each block trellis quantized in coding order, its nnz stored
            # for the next blocks' nC (jm_tpu :3124-3130)
            scan4 = np.zeros((16, 16), np.int64)
            for code in range(16):
                blk = int(CODE2RASTER[code])
                scan4[blk] = self._trellis_luma4(addr, w4[blk], blk,
                                                 intra=False)
                pic.luma_nnz[addr, blk] = int((scan4[blk] != 0).sum())
        else:
            scan4 = RN.to_scan(self._q4(w4, self.qp, False), self.scan)
        total = 0
        for qb in ME.QUAD_BLKS:
            cq = sum(RN.coeff_cost_scan(scan4[b]) for b in qb)
            if cq <= RN.LUMA_COEFF_COST:
                scan4[qb] = 0
            else:
                total += cq
        if total <= RN.LUMA_MB_COEFF_COST:
            scan4[:] = 0
        if rdoq:
            pic.luma_nnz[addr] = (scan4 != 0).sum(axis=1)
        pred_blocks = pred_y.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 4, 4)
        rec = RN.recon_luma_4x4(pred_blocks, scan4, self.qp,
                                tab=self._itab4(False), scan=self.scan) \
            .reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        if self.transform8x8 and (int(pic.inter_mode[addr]) != 3
                                  or not pic.sub_mode[addr].any()):
            t8 = self._code_luma_8x8(addr, o, pred_y, res, rec, scan4)
            if t8 is not None:
                return t8
        self.recY[py:py + 16, px:px + 16] = rec
        pic.luma_coef[addr] = scan4
        nnz = (scan4 != 0).sum(axis=1)
        pic.luma_nnz[addr] = nnz
        return sum(1 << q for q, qb in enumerate(ME.QUAD_BLKS)
                   if nnz[qb].any())

    def _code_luma_8x8(self, addr, o, pred_y, res, rec4, scan4):
        """The 8x8-transform coding of the inter luma residual res
        (jm_tpu encoder.py:3163-3198): committed, returning cbp_luma, when
        it has a nonzero level after the thresholds and its SSD +
        lambda_mode4 per nonzero level is below the 4x4 coding's (rec4,
        scan4); else None. In CAVLC each 4x4 block of an 8x8 holds every
        fourth level of its scan, whose count is the block's nnz."""
        w8 = RN.np_forward8x8(res.reshape(2, 8, 2, 8).transpose(0, 2, 1, 3)
                              .reshape(4, 8, 8))
        if self._rdoq_on and self.rd.cabac:
            # the trellis of 8x8 blocks is CABAC's (jm_tpu :3160-3169)
            scan8 = np.zeros((4, 64), np.int64)
            for q in range(4):
                scan8[q] = RQ.trellis_8x8(
                    RN.to_scan8(w8[q][None])[0], self.qp, False,
                    self._rdoq_lam(), ctxs=self.cabac_rate.w.ctxs)
        else:
            scan8 = RN.to_scan8(self._q8(w8, self.qp, False))   # (4, 64)
        total = 0
        for q in range(4):
            c8 = RN.coeff_cost_scan(scan8[q], tab=RN.COEFF_COST8)
            if c8 <= RN.LUMA_COEFF_COST:
                scan8[q] = 0
            else:
                total += c8
        if total <= RN.LUMA_MB_COEFF_COST:
            scan8[:] = 0
        n8 = int((scan8 != 0).sum())
        if not n8:
            return None
        rec8 = RN.recon_luma_8x8(
            pred_y.reshape(2, 8, 2, 8).transpose(0, 2, 1, 3).reshape(4, 8, 8),
            scan8, self.qp, tab=self._itab8(False)) \
            .reshape(2, 2, 8, 8).transpose(0, 2, 1, 3).reshape(16, 16)
        o64 = o.astype(np.int64)
        d4 = int(((o64 - rec4) ** 2).sum())
        d8 = int(((o64 - rec8) ** 2).sum())
        n4 = int((scan4 != 0).sum())
        if not d8 + self.lam4 * n8 < d4 + self.lam4 * n4:
            return None
        pic = self.pic
        pic.transform8x8[addr] = True
        pic.luma_coef8[addr] = scan8
        cbp_luma = 0
        for q in range(4):
            if scan8[q].any():
                cbp_luma |= 1 << q
            by0, bx0 = (q // 2) * 2, (q % 2) * 2
            for sub in range(4):
                pic.luma_nnz[addr, (by0 + sub // 2) * 4 + bx0 + sub % 2] = \
                    int((scan8[q, sub::4] != 0).sum())
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        self.recY[py:py + 16, px:px + 16] = rec8
        return cbp_luma

    def _commit_inter_residual(self, addr, o, pred_y, pred_u, pred_v):
        cbp_luma = self._code_luma_inter(addr, o, pred_y)
        cbp_chroma = self._code_chroma_residual(
            addr, pred_u.astype(np.int64), pred_v.astype(np.int64),
            intra=False)
        self.pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma


class BPicture(InterMBCoder):
    """One B picture coded MB by MB on the host: ``pic`` (PictureData)
    and the undeblocked recon planes recY / recU / recV (numpy uint8).
    ``mix`` counts the MBs by decision (direct, skip, l0, l1, bi, i16,
    ipcm; t8: the inter MBs coded with the 8x8 transform)."""

    stype = SliceType.B

    def __init__(self, orig, qp: int, qpc: int, lam: int, lam4: int,
                 ref0: HostRef, ref1: HostRef, col: B.ColMotion, sads0,
                 sads1, slices, sr: int, wp=None, transform8x8=False,
                 qctx=None, ar_period: int = 0, searchers=None,
                 subpel_satd: bool = True, rd=None):
        """orig: the source (Y, U, V) uint8 planes; lam / lam4:
        lambda_me and lambda_mode4 of qp; ref0 / ref1: list0[0] and
        list1[0]; col: list1[0]'s motion; sads0 / sads1: the
        (N, (2 sr + 1)^2) integer search tables against each (None with a
        searcher); slices: the slice plan, MB address lists in decode
        order; wp: the slice's weighted prediction (decoder/wp.WPParams)
        or None; transform8x8, qctx, ar_period: the adaptive 8x8
        transform and the custom quant (InterMBCoder, IntraMBCoder);
        searchers: for each list a maker of its EPZS / UMHex searcher
        from the list's motion field (encoder/me_epzs.py), or None for
        the full search; subpel_satd: SATD (else SAD) in the fractional
        search; rd: the RD tools (rdo.RDOptions; a B picture has no RD
        tier: forced I_PCM and, in CAVLC, the trellis act)."""
        if rd is not None:
            self.rd = rd
        self._init_picture(orig, qp, qpc)
        self.lam, self.lam4, self.wp = lam, lam4, wp
        self.transform8x8 = transform8x8
        self.qctx, self.ar_period = qctx, ar_period
        self.refs, self.col, self.sads = (ref0, ref1), col, (sads0, sads1)
        self.searchers = None if searchers is None else (
            searchers[0](self.pic.mv), searchers[1](self.pic.mv_l1))
        self.sr, self.satd = sr, subpel_satd
        self.h, self.w = self.origY.shape
        self.recY = np.zeros_like(self.origY)
        self.recU = np.zeros_like(self.origU)
        self.recV = np.zeros_like(self.origV)
        self.mix = dict.fromkeys(("direct", "skip", "l0", "l1", "bi",
                                  "i16", "ipcm", "t8"), 0)
        self._code_slices(slices, self._encode_b_mb)

    # ---- prediction -------------------------------------------------------

    def _pred_assemble(self, addr):
        """The MB's prediction from its motion rows in pic: (luma (16, 16),
        Cb (ch, 8), Cr (ch, 8)) int32."""
        pic = self.pic
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        cbh = self.crows                 # chroma rows per luma 4x4 row
        pred_y = np.zeros((16, 16), np.int32)
        pred_u = np.zeros((self.ch, 8), np.int32)
        pred_v = np.zeros((self.ch, 8), np.int32)
        for blk in range(16):
            by, bx = divmod(blk, 4)
            q = (by // 2) * 2 + bx // 2
            pd = int(pic.pdir[addr, q])
            if pd in (B.PD_L0, B.PD_BI):
                p0 = self._mc_blk(self.refs[0], px, py, bx, by,
                                  pic.mv[addr, blk])
            if pd in (B.PD_L1, B.PD_BI):
                p1 = self._mc_blk(self.refs[1], px, py, bx, by,
                                  pic.mv_l1[addr, blk])
            wp = self.wp
            r0, r1 = int(pic.ref_idx[addr, q]), int(pic.ref_idx_l1[addr, q])
            if pd == B.PD_L0:
                yb, ub, vb = p0
                if wp is not None:
                    yb, ub, vb = (wp.uni(p, 0, r0, c) for c, p in
                                  enumerate(p0))
            elif pd == B.PD_L1:
                yb, ub, vb = p1
                if wp is not None:
                    yb, ub, vb = (wp.uni(p, 1, r1, c) for c, p in
                                  enumerate(p1))
            elif wp is not None:
                yb, ub, vb = (wp.bi(a, b, r0, r1, c) for c, (a, b) in
                              enumerate(zip(p0, p1)))
            else:
                yb, ub, vb = ((a + b + 1) >> 1 for a, b in zip(p0, p1))
            pred_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = yb
            pred_u[by * cbh:(by + 1) * cbh, bx * 2:bx * 2 + 2] = ub
            pred_v[by * cbh:(by + 1) * cbh, bx * 2:bx * 2 + 2] = vb
        return pred_y, pred_u, pred_v

    # ---- mode decision ----------------------------------------------------

    def _best16(self, addr, origY_mb, lst):
        """The best 16x16 MV of list lst: (quarter-pel MV, cost, its
        prediction)."""
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        pred_mv = self.pctx.mv_pred(addr, 0, 0, 4, 4, 0, lst)
        if self.searchers is not None:
            imv = self.searchers[lst].search(addr, 0, (0, 1, 2, 3), pred_mv)
        else:
            imv = self._int_mv(self.sads[lst][addr], (), pred_mv)
        qmv, cost = self._subpel(origY_mb, self.refs[lst], px, py, imv,
                                 pred_mv)
        return qmv, cost, pred_mv

    def _encode_b_mb(self, addr: int) -> None:
        pic, lam = self.pic, self.lam
        if self.rd.enable_ipcm >= 2:         # forced I_PCM (:3425-3429)
            self._commit_ipcm(addr)
            pic.pdir[addr] = -1
            pic.ref_idx_l1[addr] = -1
            self.mix["ipcm"] += 1
            return
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        origY_mb = self._mb_orig(addr)[0]
        o = origY_mb.astype(np.int32)
        f0, f1 = self.refs

        # spatial direct: writes the motion rows, which every other
        # choice overwrites in full
        dp = B.prepare_direct_params(self.pctx, addr)
        for q in range(4):
            B.spatial_direct_quadrant(pic, addr, q, *dp, self.col)
        dpred = self._pred_assemble(addr)
        cost_direct = int(np.abs(o - dpred[0]).sum()) + lam

        mv0, cost_l0, pm0 = self._best16(addr, origY_mb, 0)
        mv1, cost_l1, pm1 = self._best16(addr, origY_mb, 1)
        cost_l0 += 3 * lam
        cost_l1 += 3 * lam
        p0 = ME.mc_luma_block(f0.planes, px * 4 + int(mv0[0]),
                              py * 4 + int(mv0[1]), 16, 16, self.w, self.h)
        p1 = ME.mc_luma_block(f1.planes, px * 4 + int(mv1[0]),
                              py * 4 + int(mv1[1]), 16, 16, self.w, self.h)
        cost_bi = int(np.abs(o - ((p0 + p1 + 1) >> 1)).sum()) + lam * (
            5 + ME.mv_bits(int(mv0[0] - pm0[0]), int(mv0[1] - pm0[1]))
            + ME.mv_bits(int(mv1[0] - pm1[0]), int(mv1[1] - pm1[1])))
        best = min(cost_direct, cost_l0, cost_l1, cost_bi)

        cost16, mode16, pred16 = self._eval_i16(addr, origY_mb)
        if cost16 + 2 * self.lam4 < best:
            pic.mb_class[addr] = MB_I16
            pic.pdir[addr] = -1
            pic.ref_idx[addr] = -1
            pic.ref_idx_l1[addr] = -1
            pic.ref_pic_id[addr] = -1
            pic.ref_pic_id_l1[addr] = -1
            pic.mv[addr] = 0
            pic.mv_l1[addr] = 0
            cbp_luma = self._encode_i16(addr, origY_mb, mode16, pred16)
            pic.cbp[addr] = (self._encode_chroma_intra(addr) << 4) | cbp_luma
            self.mix["i16"] += 1
            return

        pic.mb_class[addr] = MB_INTER
        if best == cost_direct:
            pic.b_direct[addr] = True
            pic.ref_pic_id[addr] = np.where(pic.ref_idx[addr] >= 0, f0.uid,
                                            -1)
            pic.ref_pic_id_l1[addr] = np.where(pic.ref_idx_l1[addr] >= 0,
                                               f1.uid, -1)
            pred = dpred
        else:
            if best == cost_l0:
                pd, r0, r1, mva, mvb, kind = B.PD_L0, 0, -1, mv0, (0, 0), "l0"
            elif best == cost_l1:
                pd, r0, r1, mva, mvb, kind = B.PD_L1, -1, 0, (0, 0), mv1, "l1"
            else:
                pd, r0, r1, mva, mvb, kind = B.PD_BI, 0, 0, mv0, mv1, "bi"
            self.mix[kind] += 1
            pic.pdir[addr] = pd
            pic.ref_idx[addr] = r0
            pic.ref_idx_l1[addr] = r1
            pic.ref_pic_id[addr] = f0.uid if r0 >= 0 else -1
            pic.ref_pic_id_l1[addr] = f1.uid if r1 >= 0 else -1
            pic.mv[addr] = np.asarray(mva, np.int32)
            pic.mv_l1[addr] = np.asarray(mvb, np.int32)
            pred = self._pred_assemble(addr)
        self._commit_inter_residual(addr, o, *pred)
        self.mix["t8"] += int(pic.transform8x8[addr])
        if pic.b_direct[addr]:
            # B_Skip: direct prediction without coded residual
            pic.skip[addr] = pic.cbp[addr] == 0
            self.mix["skip" if pic.skip[addr] else "direct"] += 1
