"""CABAC macroblock layer (spec 7.3.5, 9.3) serialized from PictureData,
twin of jm_tpu/encoder/syntax_cabac.py's MBWriterCABAC and
serialize_slice_cabac for I, P and B slices of 4:2:0 frame pictures with
the 4x4 or the adaptive 8x8 transform (transform_size_8x8_flag, each 8x8
block one LUMA_8x8 block): I_NxN (4x4), I_16x16 and I_PCM MBs (also
inside P and B slices), P_Skip and P MBs with 16x16 / 16x8 / 8x16 / 8x8 partitions, sub-8x8
partitions and several references; B_Skip, B_Direct_16x16 and 16x16 B
MBs of list 0, list 1 or both with one reference each (the B coder's
set). Every B slice counts in native.routes["b"]["serialize"].

Every writer is the exact inverse of its reader in
decoder/mb_parse_cabac.py and takes its contexts from the same
CabacNeighbours (lencod/src/cabac.c writeMB_typeInfo_CABAC, writeCBP_CABAC,
write_and_store_CBP_block_bit, writeRunLevel_CABAC). An I_PCM MB, in any
slice type, flushes the arithmetic coder before its aligned samples and
restarts it after them, as the parser does.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitwriter import BitWriter
from .. import native as N
from ..common.picture import MB_I4, MB_INTER, MB_IPCM
from ..common.predict_ctx import CODE2RASTER
from ..common.types import SliceType
from ..decoder.cabac import (C1ISDC, CHROMA_AC, CHROMA_DC, CHROMA_DC_2x4,
                             LUMA_4x4, LUMA_8x8, LUMA_16AC, LUMA_16DC,
                             MAX_C2, MAXPOS,
                             TYPE2CTX_ABS, TYPE2CTX_BCBP, TYPE2CTX_LAST,
                             TYPE2CTX_MAP, TYPE2CTX_ONE, CabacContexts,
                             pos2ctx_last, pos2ctx_map)
from ..decoder.mb_parse import _SUB_PARTS
from ..decoder.mb_parse_cabac import CabacNeighbours
from .cabac_write import CabacEncoder
from .syntax import B_MBTYPE_16x16, write_slice_header
from ..decoder.b_slice import PD_BI, PD_L0, PD_L1


class MBWriterCABAC(CabacNeighbours):
    """Serializes the MBs of one slice in the order given."""

    # P partitions per mb_type: (bx, by, bw, bh) in 4x4-block units
    PARTS = {0: [(0, 0, 4, 4)],
             1: [(0, 0, 4, 2), (0, 2, 4, 2)],
             2: [(0, 0, 2, 4), (2, 0, 2, 4)],
             3: [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)]}

    def __init__(self, bw: BitWriter, pic, slice_type: SliceType,
                 slice_qp: int, cabac_init_idc: int = 0, num_ref: int = 1,
                 t8_mode: bool = False):
        """t8_mode: the PPS's transform_8x8_mode_flag."""
        super().__init__(pic)
        self.t8_mode = t8_mode
        self.stype = slice_type
        self.num_ref = num_ref
        self.qp = slice_qp          # running QP for delta coding
        self.eng = CabacEncoder(bw)
        self.ctxs = CabacContexts(slice_type == SliceType.I, cabac_init_idc,
                                  slice_qp)
        self.last_dquant = 0

    # ---- element writers --------------------------------------------------

    def write_mb_type_i(self, addr, imb: int):
        """imb: 0 = I_NxN, 1..24 = I_16x16."""
        eng, ctx = self.eng, self.ctxs.mb_type[0]
        eng.decision(ctx, self.mb_type_i_ctx(addr), 1 if imb else 0)
        if imb == 0:
            return
        eng.terminate(0)            # not I_PCM
        k = imb - 1
        eng.decision(ctx, 4, 1 if k >= 12 else 0)
        cc = (k // 4) % 3
        eng.decision(ctx, 5, 1 if cc else 0)
        if cc:
            eng.decision(ctx, 6, 1 if cc == 2 else 0)
        eng.decision(ctx, 7, (k % 4) >> 1)
        eng.decision(ctx, 8, (k % 4) & 1)

    def write_mb_type_p(self, internal: int):
        """JM's P mb_type: 1..4 inter, 6 = I_NxN, 7..30 = I_16x16."""
        eng, ctx = self.eng, self.ctxs.mb_type[1]
        if internal in (1, 4):
            eng.decision(ctx, 4, 0)
            eng.decision(ctx, 5, 0)
            eng.decision(ctx, 6, 1 if internal == 4 else 0)
        elif internal in (2, 3):
            eng.decision(ctx, 4, 0)
            eng.decision(ctx, 5, 1)
            eng.decision(ctx, 7, 1 if internal == 2 else 0)
        elif internal == 6:
            eng.decision(ctx, 4, 1)
            eng.decision(ctx, 7, 0)
        else:
            eng.decision(ctx, 4, 1)
            eng.decision(ctx, 7, 1)
            eng.terminate(0)        # not I_PCM
            j = internal - 7
            eng.decision(ctx, 8, 1 if j >= 12 else 0)
            cc = (j // 4) % 3
            eng.decision(ctx, 9, 1 if cc else 0)
            if cc:
                eng.decision(ctx, 9, 1 if cc == 2 else 0)
            eng.decision(ctx, 10, (j % 4) >> 1)
            eng.decision(ctx, 10, (j % 4) & 1)

    def write_mb_type_b(self, addr, coded: int):
        """Inverse of read_mb_type_b: 0 B_Direct_16x16, 1..21 the
        partitions, 22 B_8x8, 23 I_NxN, 24 the I_16x16 escape (its
        continuation is write_mb_type_b_i16)."""
        eng, ctx = self.eng, self.ctxs.mb_type[2]
        eng.decision(ctx, self.mb_type_b_ctx(addr), 1 if coded else 0)
        if coded == 0:
            return
        if coded in (1, 2):
            eng.decision(ctx, 4, 0)
            eng.decision(ctx, 6, coded - 1)
            return
        if coded <= 10:
            eng.decision(ctx, 4, 1)
            eng.decision(ctx, 5, 0)
            k = coded - 3
            for b in (2, 1, 0):
                eng.decision(ctx, 6, (k >> b) & 1)
            return
        # the high branch: raw = 12 + 8 b + 4 b + 2 b, then a remap or one
        # more bin
        if coded == 11:
            raw, extra = 24, None
        elif coded == 22:
            raw, extra = 26, None
        elif coded in (23, 24):
            raw, extra = 22, coded - 23
        else:                       # 12..21
            raw, extra = 12 + ((coded - 12) & ~1), (coded - 12) & 1
        eng.decision(ctx, 4, 1)
        eng.decision(ctx, 5, 1)
        for b in (3, 2, 1):
            eng.decision(ctx, 6, ((raw - 12) >> b) & 1)
        if extra is not None:
            eng.decision(ctx, 6, extra)
        if coded == 24:
            eng.terminate(0)        # not I_PCM

    def write_mb_type_b_i16(self, k: int):
        """The I_16x16 continuation after the B escape (k = I_16x16 type
        - 1, 0..23), on the P contexts."""
        eng, ctx1 = self.eng, self.ctxs.mb_type[1]
        eng.decision(ctx1, 8, 1 if k >= 12 else 0)
        cc = (k // 4) % 3
        eng.decision(ctx1, 9, 1 if cc else 0)
        if cc:
            eng.decision(ctx1, 9, 1 if cc == 2 else 0)
        eng.decision(ctx1, 10, (k % 4) >> 1)
        eng.decision(ctx1, 10, (k % 4) & 1)

    def write_sub_mb_type_p(self, sm: int):
        """Inverse of read_sub_mb_type_p: 0 = 8x8, 1 = 8x4, 2 = 4x8,
        3 = 4x4."""
        eng, ctx = self.eng, self.ctxs.b8_type[0]
        eng.decision(ctx, 1, 1 if sm == 0 else 0)
        if sm == 0:
            return
        eng.decision(ctx, 3, 0 if sm == 1 else 1)
        if sm != 1:
            eng.decision(ctx, 4, 1 if sm == 2 else 0)

    def write_intra4_mode(self, mode: int, pred: int):
        eng, ctx = self.eng, self.ctxs.ipr
        eng.decision(ctx, 0, 1 if mode == pred else 0)
        if mode == pred:
            return
        rem = mode if mode < pred else mode - 1
        eng.decision(ctx, 1, rem & 1)
        eng.decision(ctx, 1, (rem >> 1) & 1)
        eng.decision(ctx, 1, (rem >> 2) & 1)

    def write_chroma_pred_mode(self, addr, mode: int):
        self.eng.decision(self.ctxs.cipr, self.chroma_mode_ctx(addr),
                          1 if mode else 0)
        if mode:
            self.eng.unary_max(self.ctxs.cipr, 3, 3, mode - 1, 1)

    def write_ref_idx(self, addr, bx, by, value: int, lst: int = 0):
        ctx = self.ctxs.ref_no[0]
        self.eng.decision(ctx, self.ref_idx_ctx(addr, bx, by, lst),
                          1 if value else 0)
        if value:
            self.eng.unary(ctx, 4, 5, value - 1)

    def write_mvd(self, addr, bx, by, comp, value: int, lst: int = 0):
        self.eng.decision(self.ctxs.mv_res[0],
                          self.mvd_ctx(addr, bx, by, comp, lst),
                          1 if value else 0)
        if value:
            self.eng.ueg3_mv(self.ctxs.mv_res[1], 5 * comp, abs(value) - 1)
            self.eng.bypass(1 if value < 0 else 0)

    def write_dquant(self, dq: int):
        cidx = 1 if self.last_dquant != 0 else 0
        self.eng.decision(self.ctxs.delta_qp, cidx, 1 if dq else 0)
        if dq:
            act = 2 * abs(dq) - (1 if dq > 0 else 0)
            self.eng.unary(self.ctxs.delta_qp, 2, 3, act - 1)
        self.last_dquant = dq

    def write_cbp(self, addr, cbp: int):
        eng = self.eng
        part = 0
        for mb_y in (0, 2):
            for mb_x in (0, 2):
                mask = 1 << (mb_y + (mb_x >> 1))
                bit = 1 if (cbp & mask) else 0
                eng.decision(self.ctxs.cbp[0],
                             self.cbp_luma_ctx(addr, mb_x, mb_y, part), bit)
                part += mask if bit else 0
        cc = cbp >> 4
        eng.decision(self.ctxs.cbp[1], self.cbp_chroma_ctx(addr, False),
                     1 if cc else 0)
        if cc:
            eng.decision(self.ctxs.cbp[2], self.cbp_chroma_ctx(addr, True),
                         1 if cc == 2 else 0)

    # ---- residual ---------------------------------------------------------

    def _write_sig_and_levels(self, block_type, coeff):
        """Inverse of read_significance_and_levels; coeff: scan order,
        length MAXPOS + 1, at least one nonzero."""
        eng, ctxs = self.eng, self.ctxs
        n = MAXPOS[block_type] + 1
        p2m = pos2ctx_map(block_type)
        p2l = pos2ctx_last(block_type)
        map_ctx = ctxs.map[TYPE2CTX_MAP[block_type]]
        last_ctx = ctxs.last[TYPE2CTX_LAST[block_type]]
        off = 0 if C1ISDC[block_type] else 1
        vals = [int(v) for v in coeff]
        last = max(k for k, v in enumerate(vals) if v)
        for k in range(min(last + 1, n - 1)):
            i = k + off
            sig = vals[k] != 0
            eng.decision(map_ctx, p2m[i], 1 if sig else 0)
            if sig:
                eng.decision(last_ctx, p2l[i], 1 if k == last else 0)
                if k == last:
                    break
        one_ctx = ctxs.one[TYPE2CTX_ONE[block_type]]
        abs_ctx = ctxs.abs[TYPE2CTX_ABS[block_type]]
        max_c2 = MAX_C2[block_type]
        c1, c2 = 1, 0
        for i in range(last, -1, -1):
            v = vals[i]
            if v == 0:
                continue
            av = abs(v)
            eng.decision(one_ctx, c1, 1 if av > 1 else 0)
            if av > 1:
                eng.ueg0_level(abs_ctx, c2, av - 2)
                c2 = min(c2 + 1, max_c2)
                c1 = 0
            elif c1:
                c1 = min(c1 + 1, 4)
            eng.bypass(1 if v < 0 else 0)

    def _write_block(self, addr, block_type, coeff, bx=0, by=0, comp=0):
        """coded_block_flag (setting the block's bit in pic.cbp_bits, as
        the parser does), then the coefficients if any."""
        ctx, bit0 = self.cbf_ctx(addr, block_type, bx, by, comp)
        present = bool(np.any(coeff))
        self.eng.decision(self.ctxs.bcbp[TYPE2CTX_BCBP[block_type]], ctx,
                          1 if present else 0)
        if present:
            self.pic.cbp_bits[addr] |= np.int64(1) << bit0
            self._write_sig_and_levels(block_type, coeff)

    def _write_luma_residual(self, addr, cbp, is_i16):
        pic = self.pic
        if is_i16:
            self._write_block(addr, LUMA_16DC, pic.luma_dc[addr])
        for blk8 in range(4):
            if not (cbp & (1 << blk8)):
                continue
            for sub in range(4):
                blk = int(CODE2RASTER[blk8 * 4 + sub])
                by, bx = divmod(blk, 4)
                if is_i16:
                    self._write_block(addr, LUMA_16AC,
                                      pic.luma_coef[addr, blk, 1:16], bx, by)
                else:
                    self._write_block(addr, LUMA_4x4,
                                      pic.luma_coef[addr, blk], bx, by)

    def write_transform_size(self, addr, flag: bool):
        self.eng.decision(self.ctxs.transform_size,
                          self.transform_size_ctx(addr), 1 if flag else 0)

    def _write_luma_residual_8x8(self, addr, cbp):
        """Each coded 8x8 as one LUMA_8x8 block without coded_block_flag,
        marking its 4x4 blocks' coded_block_flag bits as the parser
        does."""
        for blk8 in range(4):
            if cbp & (1 << blk8):
                coeff = self.pic.luma_coef8[addr, blk8]
                self._write_sig_and_levels(LUMA_8x8, coeff)
                self.mark_8x8(addr, blk8, coeff)

    def _write_chroma_residual(self, addr, cbp):
        """The chroma DC blocks (CHROMA_DC, or CHROMA_DC_2x4 at 4:2:2),
        then 2 n_crows AC blocks per component."""
        pic = self.pic
        cc = cbp >> 4
        dc_type = CHROMA_DC_2x4 if pic.n_crows == 4 else CHROMA_DC
        if cc & 3:
            for comp in range(2):
                self._write_block(addr, dc_type, pic.chroma_dc[addr, comp],
                                  comp=comp)
        if cc & 2:
            for comp in range(2):
                for blk in range(2 * pic.n_crows):
                    by, bx = divmod(blk, 2)
                    self._write_block(addr, CHROMA_AC,
                                      pic.chroma_coef[addr, comp, blk, 1:16],
                                      bx, by, comp)

    # ---- MB dispatch -------------------------------------------------------

    def _dquant_for(self, addr):
        dq = int(self.pic.qp[addr]) - self.qp
        if dq > 25:
            dq -= 52
        elif dq < -26:
            dq += 52
        self.qp = int(self.pic.qp[addr])
        return dq

    def _write_ipcm(self, addr):
        """I_PCM (lencod macroblock.c writeIPCMData; jm_tpu syntax_cabac
        _write_ipcm): the mb_type bins up to the I_PCM escape,
        terminate(1), which flushes the arithmetic coder, the aligned raw
        samples, then a new engine over the same contexts (its bits_out
        carried on, alignment and samples included)."""
        pic, eng = self.pic, self.eng
        if self.stype == SliceType.B:
            ctx = self.ctxs.mb_type[2]
            eng.decision(ctx, self.mb_type_b_ctx(addr), 1)
            eng.decision(ctx, 4, 1)
            eng.decision(ctx, 5, 1)
            eng.decision(ctx, 6, 1)      # raw 12 + 8
            eng.decision(ctx, 6, 0)
            eng.decision(ctx, 6, 1)      # + 2: raw 22, the intra prefix
            eng.decision(ctx, 6, 1)      # + 1: the I_16x16 / I_PCM escape
        elif self.stype == SliceType.P:
            ctx = self.ctxs.mb_type[1]
            eng.decision(ctx, 4, 1)
            eng.decision(ctx, 7, 1)
        else:
            eng.decision(self.ctxs.mb_type[0], self.mb_type_i_ctx(addr), 1)
        eng.terminate(1)
        bw = eng.bw
        pos0 = bw.bitpos
        bw.align_zero()                  # pcm_alignment_zero_bit
        for v in pic.ipcm_luma[addr].ravel():
            bw.u(int(v), 8)
        for v in pic.ipcm_chroma[addr].ravel():
            bw.u(int(v), 8)
        ne = CabacEncoder(bw)
        ne.bits_out = eng.bits_out + (bw.bitpos - pos0)
        self.eng = ne
        self.last_dquant = 0

    def _write_intra_mb(self, addr):
        pic = self.pic
        if pic.mb_class[addr] == MB_IPCM:
            self._write_ipcm(addr)
            return
        cbp = int(pic.cbp[addr])
        if pic.mb_class[addr] == MB_I4:
            imb = 0
        else:
            imb = 1 + int(pic.i16_mode[addr]) + ((cbp >> 4) << 2) \
                + (12 if cbp & 15 else 0)
        if self.stype == SliceType.B:
            self.write_mb_type_b(addr, 24 if imb else 23)
            if imb:
                self.write_mb_type_b_i16(imb - 1)
        elif self.stype == SliceType.P:
            self.write_mb_type_p(6 + imb)
        else:
            self.write_mb_type_i(addr, imb)
        if imb == 0:
            if self.t8_mode:
                self.write_transform_size(addr, False)
            for code_idx in range(16):
                blk = int(CODE2RASTER[code_idx])
                pred = self.pctx.pred_intra4_mode(addr, blk)
                self.write_intra4_mode(int(pic.i4_modes[addr, blk]), pred)
            self.write_chroma_pred_mode(addr, int(pic.chroma_mode[addr]))
            self.write_cbp(addr, cbp)
            if cbp:
                self.write_dquant(self._dquant_for(addr))
            else:
                self.last_dquant = 0
            self._write_luma_residual(addr, cbp & 15, is_i16=False)
        else:
            self.write_chroma_pred_mode(addr, int(pic.chroma_mode[addr]))
            self.write_dquant(self._dquant_for(addr))
            self._write_luma_residual(addr, cbp & 15, is_i16=True)
        self._write_chroma_residual(addr, cbp)

    def _write_p_inter_mb(self, addr):
        pic = self.pic
        mode = max(int(pic.inter_mode[addr]), 0)
        self.write_mb_type_p(mode + 1)

        def emit_mvd(bx, by, bw_, bh_, ref):
            pred = self.pctx.mv_pred(addr, bx, by, bw_, bh_, ref)
            mv = pic.mv[addr, by * 4 + bx]
            mvdx, mvdy = int(mv[0] - pred[0]), int(mv[1] - pred[1])
            self.write_mvd(addr, bx, by, 0, mvdx)
            self.write_mvd(addr, bx, by, 1, mvdy)
            for yy in range(by, by + bh_):
                pic.mvd[addr, 0, yy * 4 + bx:yy * 4 + bx + bw_] = (mvdx, mvdy)

        if mode == 3:
            for q in range(4):
                self.write_sub_mb_type_p(int(pic.sub_mode[addr, q]))
            if self.num_ref > 1:
                for q in range(4):
                    self.write_ref_idx(addr, (q % 2) * 2, (q // 2) * 2,
                                       int(pic.ref_idx[addr, q]))
            for q in range(4):
                qx, qy = (q % 2) * 2, (q // 2) * 2
                ref = int(pic.ref_idx[addr, q])
                for (sx, sy, sw, sh) in _SUB_PARTS[int(pic.sub_mode[addr, q])]:
                    emit_mvd(qx + sx, qy + sy, sw, sh, ref)
        else:
            parts = self.PARTS[mode]
            if self.num_ref > 1:
                for (bx, by, _w, _h) in parts:
                    self.write_ref_idx(addr, bx, by, int(
                        pic.ref_idx[addr, (by // 2) * 2 + bx // 2]))
            for (bx, by, bw_, bh_) in parts:
                emit_mvd(bx, by, bw_, bh_,
                         int(pic.ref_idx[addr, (by // 2) * 2 + bx // 2]))
        self._write_inter_residual(addr)

    def _write_b_inter_mb(self, addr):
        """B_Direct_16x16, or a 16x16 partition of list 0, list 1 or both
        with one reference each (jm_tpu syntax_cabac.py
        _write_b_inter_mb); each list's mvd is stored over the MB for the
        later contexts."""
        pic = self.pic
        if pic.b_direct[addr]:
            self.write_mb_type_b(addr, 0)
        else:
            pd = int(pic.pdir[addr, 0])
            self.write_mb_type_b(addr, B_MBTYPE_16x16[pd])
            for lst, use in enumerate(((PD_L0, PD_BI), (PD_L1, PD_BI))):
                if pd not in use:
                    continue
                ref = int((pic.ref_idx if lst == 0 else
                           pic.ref_idx_l1)[addr, 0])
                pred = self.pctx.mv_pred(addr, 0, 0, 4, 4, ref, lst)
                mv = (pic.mv if lst == 0 else pic.mv_l1)[addr, 0]
                mvdx, mvdy = int(mv[0] - pred[0]), int(mv[1] - pred[1])
                self.write_mvd(addr, 0, 0, 0, mvdx, lst)
                self.write_mvd(addr, 0, 0, 1, mvdy, lst)
                pic.mvd[addr, lst] = (mvdx, mvdy)
        self._write_inter_residual(addr)

    def _write_inter_residual(self, addr):
        """coded_block_pattern, mb_qp_delta and the residual of an inter
        MB."""
        pic = self.pic
        cbp = int(pic.cbp[addr])
        self.write_cbp(addr, cbp)
        if self.t8_mode and cbp & 15 and (
                int(pic.inter_mode[addr]) != 3
                or not pic.sub_mode[addr].any()):
            self.write_transform_size(addr, bool(pic.transform8x8[addr]))
        if cbp:
            self.write_dquant(self._dquant_for(addr))
        else:
            self.last_dquant = 0
        if pic.transform8x8[addr]:
            self._write_luma_residual_8x8(addr, cbp & 15)
        else:
            self._write_luma_residual(addr, cbp & 15, is_i16=False)
        self._write_chroma_residual(addr, cbp)

    def write_mb(self, addr):
        pic = self.pic
        if self.stype in (SliceType.I, SliceType.SP):
            # jm_tpu's CABAC writer writes every MB of an SP slice with its
            # I-slice branch (syntax_cabac.py:719-742), a stream no decoder
            # reads; copied for byte parity (ROADMAP Queue 3)
            self._write_intra_mb(addr)
            return
        skipped = bool(pic.skip[addr])
        is_b = self.stype == SliceType.B
        if is_b:
            self.eng.decision(self.ctxs.mb_type[2], 7 + self.skip_ctx(addr),
                              1 if skipped else 0)
        else:
            self.eng.decision(self.ctxs.mb_type[1], self.skip_ctx(addr),
                              1 if skipped else 0)
        if skipped:
            self.last_dquant = 0
        elif pic.mb_class[addr] != MB_INTER:
            self._write_intra_mb(addr)
        elif is_b:
            self._write_b_inter_mb(addr)
        else:
            self._write_p_inter_mb(addr)


def serialize_slice_cabac(pic, sps, pps, *, slice_type: SliceType,
                          frame_num: int, idr: bool, qp: int,
                          poc_lsb: int = 0, idr_pic_id: int = 0,
                          num_ref_idx_l0: int = 1, cabac_init_idc: int = 0,
                          mb_addrs=None, stats: dict | None = None,
                          **header) -> bytes:
    """Serialize one CABAC slice; mb_addrs: its MB addresses in decode
    order (default: the whole picture in raster order); header: the
    further keywords of syntax.write_slice_header (marking, list
    modification, the list-1 keywords of a B slice). The arithmetic
    coder and the contexts start afresh for each slice, and neighbours
    count only inside the slice (pic.slice_id). Returns the RBSP;
    ``stats["bins"]`` receives the bins coded (for the cabac_zero_word
    constraint). The writer updates pic.mvd and pic.cbp_bits, as the
    parser does."""
    if slice_type == SliceType.B:
        N.routes["b"]["serialize"] += 1
    addrs = list(range(pic.n_mbs) if mb_addrs is None else mb_addrs)
    bw = BitWriter()
    write_slice_header(bw, sps, pps, slice_type=slice_type,
                       frame_num=frame_num, idr=idr, idr_pic_id=idr_pic_id,
                       qp=qp, first_mb=int(addrs[0]), poc_lsb=poc_lsb,
                       num_ref_idx_l0=num_ref_idx_l0,
                       cabac_init_idc=cabac_init_idc, **header)
    while not bw.byte_aligned():
        bw.u(1, 1)                  # cabac_alignment_one_bit
    w = MBWriterCABAC(bw, pic, slice_type, qp, cabac_init_idc,
                      num_ref=num_ref_idx_l0,
                      t8_mode=bool(pps.transform_8x8_mode_flag))
    last = addrs[-1]
    for addr in addrs:
        w.write_mb(int(addr))
        w.eng.terminate(1 if addr == last else 0)   # end_of_slice_flag
    bw.align_zero()
    if stats is not None:
        stats["bins"] = w.eng.bins
    return bw.get_bytes()
