"""Host commit of a P picture encoded on the device, with the serial
re-encode of its intra macroblocks (twin of the host part of
jm_tpu/encoder/encoder.py _FrameEncoder._encode_p_device, :2252-2293),
and IntraMBCoder, the intra and trellis half of every host MB coder
(jm_tpu _FrameEncoder's _i16_candidates, _eval_i16, _encode_i16,
_encode_i4_mb, _blk_avail, _encode_chroma_intra, _code_chroma_residual,
_commit_ipcm, the RDOQ dispatch _rdoq_on .. _trellis_chroma_ac and the
slice loop of encode(), for 4:2:0 and 4:2:2, the format read from the
source planes' shapes), which encoder/intra_host.py,
encoder/b_host.py and encoder/p_host.py build on, with jm_tpu's quant
dispatch: flat quant, or the picture's encoder/qmatrix.QuantCtx,
``qctx``, for scaling matrices, explicit offsets and adaptive rounding
(the device path's commit here is always flat), and jm_tpu's RD tools
(encoder/rdo.RDOptions, ``rd``): the trellis of encoder/rdoq.py, I_PCM,
the per-mode RD of each Intra4x4 block, and per slice the running CABAC
engine of the bit counts (rdo.CabacRate).

The device's fields (ops/enc.p_frame_step, downloaded) fill the
PictureData and the undeblocked recon planes; the picture's slice plan
fills pic.slice_id, so that intra prediction, the P_Skip predictor and
the serializers see the slice boundaries. Then, in raster order, each
MB whose intra trigger fired, and each MB of the forced-refresh set, is
re-encoded as Intra16x16 with its chroma from the recon neighbours, which
are final: inter recon never reads the current picture, and each intra MB
predicts from the intra MBs re-encoded before it. With rdoq its levels
are trellis-quantized in a CAVLC stream (a CABAC stream's device route
has no running engine, so no trellis, as in jm_tpu). Last, P_Skip is
derived from the committed state (spec 8.4.1.1). This loop is serial by
nature, one MB after the other, as in jm_tpu.
"""

from __future__ import annotations

import numpy as np

from .. import native as N
from ..common.picture import MB_I4, MB_I16, MB_INTER, MB_IPCM, PictureData
from ..common.predict_ctx import CODE2RASTER, RASTER2CODE, PredCtx
from ..common.tables import QUANT_SCALE_4x4, ZIGZAG_4x4, scan_4x4
from ..common.types import SliceType
from ..decoder import intra_pred as IP
from ..decoder.recon import _np_hadamard4
from ..ops.quant import FLAT_INV_SCALE_4x4
from . import rdoq as RQ
from . import residual_np as RN
from .cavlc_write import residual_block_bits
from .rdo import CabacRate, RDOptions, count_mb_bits, lambda_mode

# the native Intra4x4 coder's flat tables: MF by qp % 6, the inverse
# scale by qp, (4, 4) int32 each
_MF4 = np.ascontiguousarray(QUANT_SCALE_4x4, np.int32)
_VS4 = np.ascontiguousarray(FLAT_INV_SCALE_4x4, np.int32)

# the device fields the commit reads (ops/enc.p_frame_step's keys)
CORE_FIELDS = ("inter_mode", "mv4", "luma_scan", "luma_nnz", "cbp",
               "chroma_dc", "chroma_scan", "chroma_nnz", "intra_mask",
               "recY", "recU", "recV")


class IntraMBCoder:
    """The intra coding of one MB (Intra16x16, Intra4x4, I_PCM, chroma)
    and the trellis of every residual block, in a picture with source
    planes origY / origU / origV, recon planes recY / recU / recV,
    PictureData ``pic`` with its PredCtx ``pctx``, slice type ``stype``,
    QPs qp / qpc and num_ref active list-0 references; qctx: the custom
    quant (None: flat), whose adaptive-rounding lists are refreshed every
    ar_period MBs of a slice; rd: the RD tools (rdo.RDOptions; the class
    default has every tool off); cabac_rate: the slice's running CABAC
    engine while one is installed (_code_slices); scan: the 4x4
    coefficient scan (the zig-zag; the field scan in a field picture, set
    by set_parity)."""

    qctx = None
    scan = ZIGZAG_4x4
    cur_parity = None
    native_i4 = True
    ar_period = 0
    units = None
    rd = RDOptions()
    stype = SliceType.P
    num_ref = 1
    cabac_rate = None

    def set_parity(self, parity) -> None:
        """A field picture's parity (0 top, 1 bottom), or None for a frame
        picture: the field scan of its levels and, in an inter coder, the
        chroma offset of its opposite-parity references."""
        self.cur_parity = parity
        self.scan = scan_4x4(parity is not None)

    def _code_slices(self, slices, code_mb) -> None:
        """Code the slice plan's MBs in order with code_mb(addr), each
        in its slice at the coder's qp, with the adaptive-rounding refresh
        before each MB and the commit after it; with basic units
        (``units``), the QP, chroma QP and lambdas of each MB's unit set
        before it (pic.qp takes it whether the MB sends it or not, as in
        jm_tpu) and the MB's bits reported after it; in a CABAC I or P
        picture with rdo or rdoq, a fresh CabacRate per slice, started at
        the coder's QP of the moment, into which each MB is committed
        once decided (jm_tpu _FrameEncoder.encode :2165-2204)."""
        pic, qctx, units, rd = self.pic, self.qctx, self.units, self.rd
        rate = rd.cabac and bool(rd.rdo or rd.rdoq) \
            and self.stype in (SliceType.I, SliceType.P)
        for sid, addrs in enumerate(slices):
            if rate:
                self.cabac_rate = CabacRate(self, self.stype)
            for mb_i, addr in enumerate(addrs):
                addr = int(addr)
                if qctx is not None:
                    qctx.maybe_refresh(mb_i, self.ar_period)
                if units is not None:
                    self.qp, self.qpc, self.lam, self.lam4 = units.params()
                pic.slice_id[addr] = sid
                pic.qp[addr] = self.qp
                code_mb(addr)
                if rate:
                    self.cabac_rate.commit(addr)
                if qctx is not None:
                    qctx.ar_commit_mb()
                if units is not None:
                    units.report(self, addr)
            self.cabac_rate = None

    def _mb_bits(self, addr: int) -> int:
        """The bits of the MB staged at addr (rdo.count_mb_bits at the
        coder's running QP)."""
        rd = self.rd
        return count_mb_bits(self.pic, rd.sps, rd.pps, self.qp, addr,
                             self.stype, self.num_ref, self.cabac_rate)

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

    # ---- the trellis (jm_tpu encoder.py:1963-2066) ------------------------

    @property
    def _rdoq_on(self) -> bool:
        """rdoq under flat quant, in CABAC only while the slice's engine
        is installed (its context states price the levels)."""
        rd = self.rd
        return bool(rd.rdoq) and self.qctx is None \
            and not (rd.cabac and self.cabac_rate is None)

    def _rdoq_lam(self) -> float:
        return lambda_mode(self.qp, intra_rdoq=(
            self._rdoq_on and self.stype == SliceType.I))

    def _trellis_luma4(self, addr, w_raster, blk, intra, i16ac=False):
        """One luma 4x4 (or Intra16x16 AC) block's levels in scan order,
        16 of them (position 0 zero for AC)."""
        w_scan = RN.to_scan(w_raster[None], self.scan)[0]
        lam = self._rdoq_lam()
        out = np.zeros(16, np.int32)
        by, bx = blk // 4, blk % 4
        if not self.rd.cabac:
            nc = self.pctx.nc_luma(addr, blk)
            if i16ac:
                out[1:] = RQ.trellis_4x4(
                    w_scan[1:], self.qp, intra, lam, entropy="cavlc",
                    block_type=1, nc=nc, max_coeff=15, start=1)
            else:
                out[:] = RQ.trellis_4x4(
                    w_scan, self.qp, intra, lam, entropy="cavlc",
                    block_type=5, nc=nc, max_coeff=16)
            return out
        w = self.cabac_rate.w
        if i16ac:
            ctx, _ = w.cbf_ctx(addr, 1, bx, by)
            out[1:] = RQ.trellis_4x4(
                w_scan[1:], self.qp, intra, lam, entropy="cabac",
                block_type=1, ctxs=w.ctxs, cbf_ctx=ctx, start=1)
        else:
            ctx, _ = w.cbf_ctx(addr, 5, bx, by)
            out[:] = RQ.trellis_4x4(
                w_scan, self.qp, intra, lam, entropy="cabac",
                block_type=5, ctxs=w.ctxs, cbf_ctx=ctx)
        return out

    def _trellis_luma_dc(self, addr, dc_t):
        """The Intra16x16 DC block (Hadamard domain, (4, 4) raster):
        levels in scan order (16,)."""
        w_scan = RN.to_scan(dc_t[None].astype(np.int64), self.scan)[0]
        lam = self._rdoq_lam()
        if not self.rd.cabac:
            nc = self.pctx.nc_luma(addr, 0)
            return RQ.trellis_4x4(w_scan, self.qp, True, lam,
                                  entropy="cavlc", block_type=0, nc=nc,
                                  max_coeff=16, dc=True)
        w = self.cabac_rate.w
        ctx, _ = w.cbf_ctx(addr, 0)
        return RQ.trellis_4x4(w_scan, self.qp, True, lam, entropy="cabac",
                              block_type=0, ctxs=w.ctxs, cbf_ctx=ctx,
                              dc=True)

    def _trellis_chroma_dc(self, addr, dc_t_flat, comp, intra):
        """A chroma DC block (4 Hadamard-domain values in raster order):
        levels (4,)."""
        lam = self._rdoq_lam()
        if not self.rd.cabac:
            return RQ.trellis_4x4(dc_t_flat, self.qpc, intra, lam,
                                  entropy="cavlc", block_type=6, nc=-1,
                                  max_coeff=4, dc=True)
        w = self.cabac_rate.w
        ctx, _ = w.cbf_ctx(addr, 6, comp=comp)
        return RQ.trellis_4x4(dc_t_flat, self.qpc, intra, lam,
                              entropy="cabac", block_type=6, ctxs=w.ctxs,
                              cbf_ctx=ctx, dc=True)

    def _trellis_chroma_ac(self, addr, w_raster, comp, blk, intra):
        """A chroma AC 4x4 block (positions 1..15): scan levels (16,)."""
        w_scan = RN.to_scan(w_raster[None], self.scan)[0]
        lam = self._rdoq_lam()
        out = np.zeros(16, np.int32)
        if not self.rd.cabac:
            nc = self.pctx.nc_chroma(addr, comp, blk)
            out[1:] = RQ.trellis_4x4(w_scan[1:], self.qpc, intra, lam,
                                     entropy="cavlc", block_type=7, nc=nc,
                                     max_coeff=15, start=1)
            return out
        w = self.cabac_rate.w
        ctx, _ = w.cbf_ctx(addr, 7, blk % 2, blk // 2, comp)
        out[1:] = RQ.trellis_4x4(w_scan[1:], self.qpc, intra, lam,
                                 entropy="cabac", block_type=7,
                                 ctxs=w.ctxs, cbf_ctx=ctx, start=1)
        return out

    def _init_picture(self, orig, qp: int, qpc: int) -> PictureData:
        """The source planes, QPs and an empty PictureData; chroma planes
        as tall as the luma make a 4:2:2 picture (crows 4, chroma MBs
        ch = 16 rows), else 4:2:0 (crows 2, ch = 8)."""
        self.origY, self.origU, self.origV = (np.asarray(p, np.uint8)
                                              for p in orig)
        self.mb_h, self.mb_w = (s // 16 for s in self.origY.shape)
        self.qp, self.qpc = qp, qpc
        cfi = 2 if self.origU.shape[0] == self.origY.shape[0] else 1
        self.pic = PictureData(self.mb_w, self.mb_h, cfi)
        self.crows = self.pic.n_crows
        self.ch = 4 * self.crows
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
                *(p[self._csl(addr)] for p in (self.origU, self.origV)))

    def _csl(self, addr):
        """MB addr's chroma block (ch x 8) as a pair of slices."""
        cy, cx = (addr // self.mb_w) * self.ch, (addr % self.mb_w) * 8
        return slice(cy, cy + self.ch), slice(cx, cx + 8)

    def _avail(self, addr):
        """(left, top, top-left) neighbour availability of MB addr."""
        av = self.pctx.avail
        left = addr % self.mb_w > 0
        return (left and av(addr - 1, addr), av(addr - self.mb_w, addr),
                left and av(addr - self.mb_w - 1, addr))

    # ---- I_PCM (jm_tpu encoder.py:2880-2903) ------------------------------

    def _commit_ipcm(self, addr) -> None:
        """I_PCM: the source samples are the recon, raised to 1 below the
        High profiles (lencod.c min_IPCM_value); nnz 16 for the nC of
        later blocks, no residual, the running QP kept."""
        pic = self.pic
        py, px = (addr // self.mb_w) * 16, (addr % self.mb_w) * 16
        oY, oU, oV = self._mb_orig(addr)
        minv = 1 if self.rd.sps.profile_idc < 100 else 0
        Y, U, V = (np.maximum(p, minv).astype(np.uint8) for p in (oY, oU,
                                                                  oV))
        pic.mb_class[addr] = MB_IPCM
        pic.ipcm_luma[addr] = Y
        pic.ipcm_chroma[addr] = np.stack([U, V])
        pic.luma_nnz[addr] = 16
        pic.chroma_nnz[addr] = 16
        pic.qp[addr] = self.qp
        pic.ref_idx[addr] = -1
        pic.cbp[addr] = 0
        self.recY[py:py + 16, px:px + 16] = Y
        self.recU[self._csl(addr)] = U
        self.recV[self._csl(addr)] = V

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
        """Code MB addr as Intra16x16 with `pred`; returns cbp_luma. With
        the trellis on, each AC block (in coding order, its nnz stored for
        the next blocks' nC) and, with rdoq_dc, the DC block are trellis
        quantized."""
        pic, qp = self.pic, self.qp
        py, px = (addr // self.mb_w) * 16, (addr % self.mb_w) * 16
        res = origY_mb.astype(np.int64) - pred
        blocks = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 4, 4)
        w = RN.np_forward4x4(blocks)
        # JM's forward Hadamard carries a >> 1 (lcommon transform.c:163)
        dc_t = _np_hadamard4(w[:, 0, 0].reshape(4, 4)) >> 1
        if self._rdoq_on:
            if self.rd.rdoq_dc:
                dc_scan = self._trellis_luma_dc(addr, dc_t).astype(np.int64)
            else:
                dc_scan = RN.to_scan(self._qdc(dc_t, qp, True)
                                     .reshape(1, 4, 4), self.scan)[0]
            ac_scan = np.zeros((16, 16), np.int64)
            for code in range(16):
                blk = int(CODE2RASTER[code])
                ac_scan[blk] = self._trellis_luma4(addr, w[blk], blk, True,
                                                   i16ac=True)
                pic.luma_nnz[addr, blk] = int((ac_scan[blk] != 0).sum())
        else:
            dc_scan = RN.to_scan(self._qdc(dc_t, qp, True)
                                 .reshape(1, 4, 4), self.scan)[0]
            ac_scan = RN.to_scan(self._q4(w, qp, True), self.scan)
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
                                tab=self._itab4(True), scan=self.scan)
        self.recY[py:py + 16, px:px + 16] = \
            rec.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        return cbp_luma

    # ---- Intra4x4 luma (jm_tpu encoder.py:2407-2522) ----------------------

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
        """Code MB addr as Intra4x4, block after block (each coded and
        reconstructed before the next); returns (the sum of the chosen
        modes' costs, cbp_luma). A block's mode: by SAD plus lambda_mode4
        off the most probable mode, or with rdo by J = SSD +
        lambda_mode (mode bits + the block's CAVLC bits, whatever the
        entropy coder) over every candidate coded and reconstructed (its
        cost int(J)); with the trellis on, its levels trellis
        quantized. Without an RD tier, the trellis or custom quant the MB
        is coded by the native runtime's twin of this loop
        (jm_tpu_torch/native, jm_dec.cpp encode_i4_mb; ``native_i4``
        False: this loop)."""
        if self.native_i4 and not self.rd.rdo and self.qctx is None \
                and not self._rdoq_on:
            pic = self.pic
            return N.load().encode_i4_mb(
                {"mb_w": self.mb_w, "mb_h": self.mb_h, "addr": addr,
                 "qp": self.qp, "lam4": int(self.lam4)},
                {"Y": self.recY, "orig": np.ascontiguousarray(origY_mb,
                                                              np.uint8),
                 "mb_class": pic.mb_class, "i4_modes": pic.i4_modes,
                 "slice_id": pic.slice_id, "luma_coef": pic.luma_coef,
                 "luma_nnz": pic.luma_nnz, "mf": _MF4[self.qp % 6],
                 "vs": _VS4[self.qp],
                 "scan": np.ascontiguousarray(self.scan, np.int32)})
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
            preds = IP.predict_i4_all(top, left, corner, avail_t, avail_l)
            scan = None
            if self.rd.rdo:
                # rdcost_for_4x4_intra_blocks (lencod rdopt.c:523)
                lam_md = self._rdoq_lam()
                nc = self.pctx.nc_luma(addr, blk)
                best = None
                for m in cand:
                    pred = preds[m]
                    w = RN.np_forward4x4((o - pred)[None])[0]
                    scan_m = self._i4_levels(addr, w, blk)
                    rec_m = RN.recon_luma_4x4(pred[None], scan_m[None], qp,
                                              tab=self._itab4(True),
                                              scan=self.scan)[0]
                    ssd = int(((o - rec_m.astype(np.int64)) ** 2).sum())
                    j = ssd + lam_md * ((1 if m == mpm else 4)
                                        + residual_block_bits(
                                            scan_m.tolist(), nc, 16))
                    if best is None or j < best[0]:
                        best = (j, m, pred, scan_m)
                j, m, pred, scan = best
                cost = int(j)
            else:
                # SAD + lambda_mode4 off the most probable mode, the first
                # candidate of least cost
                c = np.array(cand)
                costs = np.abs(o[None] - preds[c]).sum(axis=(1, 2)) \
                    + self.lam4 * (c != mpm)
                i = int(np.argmin(costs))
                cost, m, pred = int(costs[i]), cand[i], preds[cand[i]]
            total_cost += cost
            pic.i4_modes[addr, blk] = m
            if scan is None:
                scan = self._i4_levels(addr, RN.np_forward4x4(
                    (o - pred)[None])[0], blk)
            pic.luma_coef[addr, blk] = scan
            tc = int((scan != 0).sum())
            pic.luma_nnz[addr, blk] = tc
            if tc:
                coded_quads.add((by // 2) * 2 + bx // 2)
            Y[y:y + 4, x:x + 4] = RN.recon_luma_4x4(
                pred[None], scan[None], qp, tab=self._itab4(True),
                scan=self.scan)[0]
        return total_cost, sum(1 << q for q in coded_quads)

    def _i4_levels(self, addr, w, blk):
        """An Intra4x4 block's levels in scan order: trellis or quant."""
        if self._rdoq_on:
            return self._trellis_luma4(addr, w, blk, intra=True)
        return RN.to_scan(self._q4(w[None], self.qp, True), self.scan)[0]

    # ---- chroma -----------------------------------------------------------

    def _encode_chroma_intra(self, addr) -> int:
        """Best-SAD chroma mode over Cb + Cr (8x8, or 8x16 at 4:2:2),
        coded; returns cbp_chroma."""
        ch = self.ch
        cy, cx = (addr // self.mb_w) * ch, (addr % self.mb_w) * 8
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
                left = plane[cy:cy + ch, cx - 1].astype(np.int32) \
                    if avail_l else np.zeros(ch, np.int32)
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
        (block.c:954-1160: the 2x2 DC Hadamard at 4:2:0, the 2x4 one at
        QPc + 3 at 4:2:2) with the intra or the inter rounding offset, the
        trellis on the DC (rdoq_dc_cr, 4:2:0 only, as in jm_tpu) and AC
        (rdoq_cr) blocks while it is on; returns cbp_chroma (0/1/2)."""
        pic, qpc, rd = self.pic, self.qpc, self.rd
        crows, nb = self.crows, 2 * self.crows
        origU, origV = self._mb_orig(addr)[1:]
        rdoq = self._rdoq_on
        store = []
        for comp, pred, orig in ((0, predU, origU), (1, predV, origV)):
            res = orig.astype(np.int64) - pred
            w = RN.np_forward4x4(res.reshape(crows, 4, 2, 4)
                                 .transpose(0, 2, 1, 3).reshape(nb, 4, 4))
            if crows == 4:
                dc_lev = RN.quant_dc422(
                    w[:, 0, 0], qpc, intra,
                    qfn=lambda f, q, i, c=comp + 1: self._qdc(f, q, i, c))
            else:
                dc_t = RN.np_hadamard2x2(w[:, 0, 0].reshape(2, 2))
                if rdoq and rd.rdoq_dc_cr:
                    dc_lev = self._trellis_chroma_dc(
                        addr, dc_t.reshape(4), comp, intra).astype(np.int64)
                else:
                    dc_lev = self._qdc(dc_t, qpc, intra,
                                       comp + 1).reshape(4)
            if rdoq and rd.rdoq_cr:
                ac_scan = np.zeros((nb, 16), np.int64)
                for blk in range(nb):
                    ac_scan[blk] = self._trellis_chroma_ac(addr, w[blk], comp,
                                                           blk, intra)
                    pic.chroma_nnz[addr, comp, blk] = int(
                        (ac_scan[blk] != 0).sum())
            else:
                ac_scan = RN.to_scan(self._q4(w, qpc, intra, comp + 1),
                                     self.scan)
                ac_scan[:, 0] = 0
            cost_c = sum(RN.coeff_cost_scan(ac_scan[b], start=1)
                         for b in range(nb))
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
            pred_blocks = pred.reshape(crows, 4, 2, 4).transpose(0, 2, 1, 3) \
                .reshape(nb, 4, 4)
            recon = RN.recon_chroma if crows == 2 else RN.recon_chroma422
            rec = recon(pred_blocks, ac_scan, dc_lev, qpc,
                        tab=self._itab4(intra, comp + 1), scan=self.scan)
            plane = self.recU if comp == 0 else self.recV
            plane[self._csl(addr)] = rec.reshape(crows, 2, 4, 4) \
                .transpose(0, 2, 1, 3).reshape(self.ch, 8)
        return cbp_chroma


class PictureCommit(IntraMBCoder):
    """One P picture's host state: ``pic`` (PictureData) and the
    undeblocked recon planes recY / recU / recV (numpy uint8).
    ``intra_mbs`` lists the MBs re-encoded as intra."""

    def __init__(self, core: dict, orig, qp: int, qpc: int, forced,
                 slices, rd: RDOptions | None = None):
        """core: the CORE_FIELDS as numpy arrays; orig: the source
        (Y, U, V) uint8 planes; forced: MB addresses to code as intra
        whatever the trigger says (intra refresh); slices: the picture's
        slice plan, MB address lists in decode order; rd: the RD tools
        (of which only the trellis acts here)."""
        if rd is not None:
            self.rd = rd
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
