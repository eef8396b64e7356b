"""Host commit of a P picture encoded on the device, with the serial
re-encode of its intra macroblocks (twin of the host part of
jm_tpu/encoder/encoder.py _FrameEncoder._encode_p_device, :2252-2293, and
of its _i16_candidates, _eval_i16, _encode_i16, _encode_chroma_intra and
_code_chroma_residual for 4:2:0 without trellis, which IntraMBCoder holds
for this module, encoder/intra_host.py, encoder/b_host.py and
encoder/p_host.py, with jm_tpu's quant dispatch: flat quant, or the
picture's encoder/qmatrix.QuantCtx, ``qctx``, for scaling matrices,
explicit offsets and adaptive rounding; the device path's commit here is
always flat).

The device's fields (ops/enc.p_frame_step, downloaded) fill the
PictureData and the undeblocked recon planes; the picture's slice plan
fills pic.slice_id, so that intra prediction, the P_Skip predictor and
the serializers see the slice boundaries. Then, in raster order, each
MB whose intra trigger fired, and each MB of the forced-refresh set, is
re-encoded as Intra16x16 with its chroma from the recon neighbours, which
are final: inter recon never reads the current picture, and each intra MB
predicts from the intra MBs re-encoded before it. Last, P_Skip is derived
from the committed state (spec 8.4.1.1). This loop is serial by nature,
one MB after the other, as in jm_tpu.
"""

from __future__ import annotations

import numpy as np

from ..common.picture import MB_I16, MB_INTER, PictureData
from ..common.predict_ctx import PredCtx
from ..decoder import intra_pred as IP
from ..decoder.recon import _np_hadamard4
from . import residual_np as RN

# the device fields the commit reads (ops/enc.p_frame_step's keys)
CORE_FIELDS = ("inter_mode", "mv4", "luma_scan", "luma_nnz", "cbp",
               "chroma_dc", "chroma_scan", "chroma_nnz", "intra_mask",
               "recY", "recU", "recV")


class IntraMBCoder:
    """The Intra16x16 and chroma intra coding of one MB of a picture with
    source planes origY / origU / origV, recon planes recY / recU / recV,
    PictureData ``pic`` with its PredCtx ``pctx``, and QPs qp / qpc;
    qctx: the custom quant (None: flat), whose adaptive-rounding lists
    are refreshed every ar_period MBs of a slice."""

    qctx = None
    ar_period = 0
    units = None

    def _code_slices(self, slices, code_mb) -> None:
        """Code the slice plan's MBs in order with code_mb(addr), each
        in its slice at the coder's qp, with the adaptive-rounding refresh
        before each MB and the commit after it; with basic units
        (``units``), the QP, chroma QP and lambdas of each MB's unit set
        before it (pic.qp takes it whether the MB sends it or not, as in
        jm_tpu) and the MB's bits reported after it (jm_tpu
        _FrameEncoder.encode :2175-2203)."""
        pic, qctx, units = self.pic, self.qctx, self.units
        for sid, addrs in enumerate(slices):
            for mb_i, addr in enumerate(addrs):
                if qctx is not None:
                    qctx.maybe_refresh(mb_i, self.ar_period)
                if units is not None:
                    self.qp, self.qpc, self.lam, self.lam4 = units.params()
                pic.slice_id[addr] = sid
                pic.qp[addr] = self.qp
                code_mb(int(addr))
                if qctx is not None:
                    qctx.ar_commit_mb()
                if units is not None:
                    units.report(pic, int(addr), self.qp)

    # ---- quant dispatch (jm_tpu encoder.py:1925-1946) ---------------------

    def _q4(self, w, qp, intra, plane=0):
        if self.qctx is None:
            return RN.np_quant_4x4(w, qp, intra)
        return self.qctx.quant_4x4(w, qp, plane, intra)

    def _qdc(self, dc, qp, intra, plane=0):
        if self.qctx is None:
            return RN.np_quant_dc(dc, qp, intra)
        return self.qctx.quant_dc(dc, qp, plane, intra)

    def _q8(self, w, qp, intra):
        if self.qctx is None:
            return RN.np_quant_8x8(w, qp, intra)
        return self.qctx.quant_8x8(w, qp, intra)

    def _itab4(self, intra, plane=0):
        return None if self.qctx is None else self.qctx.inv_tab4(plane, intra)

    def _itab8(self, intra):
        return None if self.qctx is None else self.qctx.inv_tab8(intra)

    def _init_picture(self, orig, qp: int, qpc: int) -> PictureData:
        self.origY, self.origU, self.origV = (np.asarray(p, np.uint8)
                                              for p in orig)
        self.mb_h, self.mb_w = (s // 16 for s in self.origY.shape)
        self.qp, self.qpc = qp, qpc
        self.pic = PictureData(self.mb_w, self.mb_h)
        self.pctx = PredCtx(self.pic)
        return self.pic

    @property
    def rec(self):
        """The undeblocked (Y, U, V) recon planes."""
        return self.recY, self.recU, self.recV

    # ---- helpers ----------------------------------------------------------

    def _mb_orig(self, addr):
        py, px = (addr // self.mb_w) * 16, (addr % self.mb_w) * 16
        return (self.origY[py:py + 16, px:px + 16],
                self.origU[py // 2:py // 2 + 8, px // 2:px // 2 + 8],
                self.origV[py // 2:py // 2 + 8, px // 2:px // 2 + 8])

    def _avail(self, addr):
        """(left, top, top-left) neighbour availability of MB addr."""
        av = self.pctx.avail
        left = addr % self.mb_w > 0
        return (left and av(addr - 1, addr), av(addr - self.mb_w, addr),
                left and av(addr - self.mb_w - 1, addr))

    # ---- Intra16x16 luma --------------------------------------------------

    def _eval_i16(self, addr, origY_mb):
        """Best-SAD Intra16x16 mode: (cost, mode, prediction)."""
        py, px = (addr // self.mb_w) * 16, (addr % self.mb_w) * 16
        avail_l, avail_t, avail_tl = self._avail(addr)
        rec = self.recY
        top = rec[py - 1, px:px + 16].astype(np.int32) if avail_t \
            else np.zeros(16, np.int32)
        left = rec[py:py + 16, px - 1].astype(np.int32) if avail_l \
            else np.zeros(16, np.int32)
        corner = int(rec[py - 1, px - 1]) if avail_tl else 0
        modes = [IP.I16_DC]
        if avail_t:
            modes.append(IP.I16_VERT)
        if avail_l:
            modes.append(IP.I16_HOR)
        if avail_t and avail_l and avail_tl:
            modes.append(IP.I16_PLANE)
        best = None
        o = origY_mb.astype(np.int32)
        for m in modes:
            pred = IP.predict_i16(m, top, left, corner, avail_t, avail_l)
            sad = int(np.abs(o - pred).sum())
            if best is None or sad < best[0]:
                best = (sad, m, pred)
        return best

    def _encode_i16(self, addr, origY_mb, mode, pred) -> int:
        """Code MB addr as Intra16x16 with `pred`; returns cbp_luma."""
        pic, qp = self.pic, self.qp
        py, px = (addr // self.mb_w) * 16, (addr % self.mb_w) * 16
        res = origY_mb.astype(np.int64) - pred
        blocks = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 4, 4)
        w = RN.np_forward4x4(blocks)
        # JM's forward Hadamard carries a >> 1 (lcommon transform.c:163)
        dc_t = _np_hadamard4(w[:, 0, 0].reshape(4, 4)) >> 1
        dc_scan = RN.to_scan(self._qdc(dc_t, qp, True).reshape(1, 4, 4))[0]
        ac_scan = RN.to_scan(self._q4(w, qp, True))
        ac_scan[:, 0] = 0
        pic.mb_class[addr] = MB_I16
        pic.i16_mode[addr] = mode
        pic.luma_dc[addr] = dc_scan
        nnz = (ac_scan[:, 1:] != 0).sum(axis=1)
        cbp_luma = 15 if nnz.any() else 0
        if not cbp_luma:
            ac_scan[:, :] = 0
        pic.luma_coef[addr] = ac_scan
        pic.luma_nnz[addr] = nnz
        pred_blocks = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 4, 4)
        rec = RN.recon_luma_i16(pred_blocks, ac_scan, dc_scan, qp,
                                tab=self._itab4(True))
        self.recY[py:py + 16, px:px + 16] = \
            rec.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        return cbp_luma

    # ---- chroma -----------------------------------------------------------

    def _encode_chroma_intra(self, addr) -> int:
        """Best-SAD chroma mode over Cb + Cr, coded; returns cbp_chroma."""
        cy, cx = (addr // self.mb_w) * 8, (addr % self.mb_w) * 8
        avail_l, avail_t, avail_tl = self._avail(addr)
        origU, origV = self._mb_orig(addr)[1:]
        modes = [IP.C_DC]
        if avail_l:
            modes.append(IP.C_HOR)
        if avail_t:
            modes.append(IP.C_VERT)
        if avail_t and avail_l and avail_tl:
            modes.append(IP.C_PLANE)
        best = None
        for m in modes:
            sad = 0
            preds = []
            for plane, orig in ((self.recU, origU), (self.recV, origV)):
                top = plane[cy - 1, cx:cx + 8].astype(np.int32) if avail_t \
                    else np.zeros(8, np.int32)
                left = plane[cy:cy + 8, cx - 1].astype(np.int32) if avail_l \
                    else np.zeros(8, np.int32)
                corner = int(plane[cy - 1, cx - 1]) if avail_tl else 0
                pred = IP.predict_chroma(m, top, left, corner, avail_t,
                                         avail_l)
                sad += int(np.abs(orig.astype(np.int32) - pred).sum())
                preds.append(pred)
            if best is None or sad < best[0]:
                best = (sad, m, preds)
        _sad, mode, (predU, predV) = best
        self.pic.chroma_mode[addr] = mode
        return self._code_chroma_residual(addr, predU, predV)

    def _code_chroma_residual(self, addr, predU, predV,
                              intra: bool = True) -> int:
        """Quantize, commit and reconstruct the chroma residual of MB addr
        (2x2 DC Hadamard, block.c:954-1160) with the intra or the inter
        rounding offset; returns cbp_chroma (0/1/2)."""
        pic, qpc = self.pic, self.qpc
        cy, cx = (addr // self.mb_w) * 8, (addr % self.mb_w) * 8
        origU, origV = self._mb_orig(addr)[1:]
        store = []
        for plane, pred, orig in ((1, predU, origU), (2, predV, origV)):
            res = orig.astype(np.int64) - pred
            w = RN.np_forward4x4(res.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
                                 .reshape(4, 4, 4))
            dc_lev = self._qdc(RN.np_hadamard2x2(w[:, 0, 0].reshape(2, 2)),
                               qpc, intra, plane).reshape(4)
            ac_scan = RN.to_scan(self._q4(w, qpc, intra, plane))
            ac_scan[:, 0] = 0
            cost_c = sum(RN.coeff_cost_scan(ac_scan[b], start=1)
                         for b in range(4))
            if cost_c < RN.CHROMA_COEFF_COST:
                ac_scan[:, :] = 0
            store.append((dc_lev, ac_scan, pred))
        any_ac = any((ac[:, 1:] != 0).any() for _d, ac, _p in store)
        any_dc = any((dc != 0).any() for dc, _a, _p in store)
        cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
        for comp, (dc_lev, ac_scan, pred) in enumerate(store):
            if cbp_chroma < 2:
                ac_scan[:, :] = 0
            if cbp_chroma == 0:
                dc_lev[:] = 0
            pic.chroma_dc[addr, comp] = dc_lev
            pic.chroma_coef[addr, comp] = ac_scan
            pic.chroma_nnz[addr, comp] = (ac_scan[:, 1:] != 0).sum(axis=1)
            pred_blocks = pred.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3) \
                .reshape(4, 4, 4)
            rec = RN.recon_chroma(pred_blocks, ac_scan, dc_lev, qpc,
                                  tab=self._itab4(intra, comp + 1))
            plane = self.recU if comp == 0 else self.recV
            plane[cy:cy + 8, cx:cx + 8] = \
                rec.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
        return cbp_chroma


class PictureCommit(IntraMBCoder):
    """One P picture's host state: ``pic`` (PictureData) and the
    undeblocked recon planes recY / recU / recV (numpy uint8).
    ``intra_mbs`` lists the MBs re-encoded as intra."""

    def __init__(self, core: dict, orig, qp: int, qpc: int, forced,
                 slices):
        """core: the CORE_FIELDS as numpy arrays; orig: the source
        (Y, U, V) uint8 planes; forced: MB addresses to code as intra
        whatever the trigger says (intra refresh); slices: the picture's
        slice plan, MB address lists in decode order."""
        pic = self._init_picture(orig, qp, qpc)
        for sid, addrs in enumerate(slices):
            pic.slice_id[addrs] = sid
        pic.qp[:] = qp
        pic.mb_class[:] = MB_INTER
        pic.inter_mode[:] = core["inter_mode"]
        pic.mv[:] = core["mv4"]
        pic.ref_idx[:] = 0
        pic.ref_pic_id[:] = 0
        pic.pdir[:] = 0
        pic.sub_mode[:] = 0
        pic.luma_coef[:] = core["luma_scan"]
        pic.luma_nnz[:] = core["luma_nnz"]
        pic.chroma_dc[:] = core["chroma_dc"]
        pic.chroma_coef[:] = core["chroma_scan"]
        pic.chroma_nnz[:] = core["chroma_nnz"]
        pic.cbp[:] = core["cbp"]
        self.recY = np.array(core["recY"], np.uint8)
        self.recU = np.array(core["recU"], np.uint8)
        self.recV = np.array(core["recV"], np.uint8)

        intra = np.array(core["intra_mask"], bool)
        intra[list(forced)] = True
        self.intra_mbs = [int(a) for a in np.flatnonzero(intra)]
        for addr in self.intra_mbs:
            pic.ref_idx[addr] = -1
            pic.ref_pic_id[addr] = -1
            pic.mv[addr] = 0
            origY_mb = self._mb_orig(addr)[0]
            _c, m16, p16 = self._eval_i16(addr, origY_mb)
            cbp_luma = self._encode_i16(addr, origY_mb, m16, p16)
            cbp_chroma = self._encode_chroma_intra(addr)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma

        # P_Skip: 16x16, reference 0, no coefficients, MV == skip predictor
        cand = np.flatnonzero((pic.cbp == 0) & (pic.inter_mode == 0)
                              & (pic.mb_class == MB_INTER)
                              & (pic.ref_idx[:, 0] == 0))
        for addr in cand:
            addr = int(addr)
            if (pic.mv[addr, 0] == self.pctx.skip_mv(addr)).all():
                pic.skip[addr] = True
