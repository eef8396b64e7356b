"""Macroblock-layer parsing of CABAC I, P and B slices (spec 7.3.5,
9.3.3.1), twin of jm_tpu/decoder/mb_parse_cabac.py's MBParserCABAC for
frame pictures of 8 to 14 bits with the 4x4 and the adaptive 8x8
transform.

It fills the same picture-wide SoA arrays (common/picture.PictureData) as
the CAVLC parser, plus the two the context selection reads: the mvd of
every 4x4 block and the coded_block_flag bits (ldecod/src/mb_read.c
read_one_macroblock_{i,p}_slice_cabac). ``CabacNeighbours`` holds the
context selections from the neighbouring MBs and blocks (the ctxIdxInc
derivations of spec 9.3.3.1.1, ldecod/src/cabac.c); the encoder's
writer (encoder/syntax_cabac.py) uses the same class. Predictors come
from common/predict_ctx.PredCtx, as for CAVLC; B direct motion from
decoder/b_slice.py. In B slices a neighbour coded B_Skip or
B_Direct_16x16 does not count for the mb_type context, and a direct
neighbour (MB or 8x8) none for the ref_idx context; the mvd context reads
the list being coded. transform_size_8x8_flag takes its context from the
neighbours' flags; an 8x8 block is one LUMA_8x8 block (category 5, no
coded_block_flag, the frame 8x8 significance and last maps), which
stands for each of its four 4x4 blocks in the coded_block_flag bits
that later contexts read, and whose count is their nnz. An SP slice
raises NotImplementedError, as jm_tpu's CABAC parser has none. Every B slice counts in
native.routes["b"]["parse"]. The arithmetic
decoder is the
native CabacEngine unless the caller asks for the Python twin
(``native=False``); each slice's choice is counted in
native.routes["cabac"].
"""

from __future__ import annotations

import numpy as np

from .. import native as N
from ..bitstream.bitreader import BitReader
from ..common.picture import MB_I4, MB_I16, MB_INTER, MB_IPCM, PictureData
from ..common.predict_ctx import CODE2RASTER, PredCtx
from ..common.types import SliceType
from . import b_slice as B
from .cabac import (CHROMA_AC, CHROMA_DC, CHROMA_DC_2x4, LUMA_4x4,
                    LUMA_8x8, LUMA_16AC, LUMA_16DC, TYPE2CTX_BCBP,
                    CabacContexts, CabacEngine, PyCabacEngine,
                    read_significance_and_levels)
from .mb_parse import (_P_PARTS, _SUB_PARTS, SliceContext, b_allow8,
                       apply_qp_delta, ipcm_format_check, p_allow8,
                       read_pcm_samples)


class CabacNeighbours:
    """Context selection (ctxIdxInc) of the CABAC syntax elements from
    the MBs and blocks already coded in ``pic``, shared by the parser and
    the writer so that both derive the same contexts."""

    def __init__(self, pic: PictureData):
        self.pic = pic
        self.mb_w = pic.mb_w
        self.pctx = PredCtx(pic)

    def _left_mb(self, addr):
        naddr = addr - 1 if addr % self.mb_w else -1
        return naddr if naddr >= 0 and self.pctx.avail(naddr, addr) else -1

    def _up_mb(self, addr):
        naddr = addr - self.mb_w
        return naddr if naddr >= 0 and self.pctx.avail(naddr, addr) else -1

    def _blk_neighbor(self, addr, bx, by):
        """The 4x4 luma block at block coords (bx, by) relative to MB addr:
        (naddr, raster blk), or None if unavailable (blocks of addr itself
        are always available)."""
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        gx, gy = mbx * 4 + bx, mby * 4 + by
        if gx < 0 or gy < 0 or gx >= self.mb_w * 4:
            return None
        naddr = (gy // 4) * self.mb_w + (gx // 4)
        if naddr != addr and (naddr > addr
                              or not self.pctx.avail(naddr, addr)):
            return None
        return naddr, (gy % 4) * 4 + (gx % 4)

    def _cblk_neighbor(self, addr, cx, cy):
        """The chroma 4x4 block at (cx, cy) on the MB's 2-wide grid of
        n_crows rows (2x2 at 4:2:0, 2x4 at 4:2:2): (naddr, blk) or None
        (ldecod get4x4NeighbourBase on chroma)."""
        crows = self.pic.n_crows
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        gx, gy = mbx * 2 + cx, mby * crows + cy
        if gx < 0 or gy < 0 or gx >= self.mb_w * 2:
            return None
        naddr = (gy // crows) * self.mb_w + (gx // 2)
        if naddr != addr and (naddr > addr
                              or not self.pctx.avail(naddr, addr)):
            return None
        return naddr, (gy % crows) * 2 + (gx % 2)

    def skip_ctx(self, addr) -> int:
        """mb_skip_flag's context in P slices (B slices add 7)."""
        pic = self.pic
        la, ua = self._left_mb(addr), self._up_mb(addr)
        return ((1 if la >= 0 and not pic.skip[la] else 0)
                + (1 if ua >= 0 and not pic.skip[ua] else 0))

    def mb_type_b_ctx(self, addr) -> int:
        """The first B mb_type bin's context: neighbours neither B_Skip
        nor B_Direct_16x16."""
        pic = self.pic

        def term(n):
            return 1 if n >= 0 and not (pic.skip[n] or pic.b_direct[n]) \
                else 0

        return term(self._left_mb(addr)) + term(self._up_mb(addr))

    def mb_type_i_ctx(self, addr) -> int:
        pic = self.pic
        la, ua = self._left_mb(addr), self._up_mb(addr)
        return ((1 if la >= 0 and pic.mb_class[la] != MB_I4 else 0)
                + (1 if ua >= 0 and pic.mb_class[ua] != MB_I4 else 0))

    def chroma_mode_ctx(self, addr) -> int:
        pic = self.pic

        def term(n):
            return 1 if (n >= 0 and pic.chroma_mode[n] != 0
                         and pic.mb_class[n] != MB_IPCM) else 0

        return term(self._left_mb(addr)) + term(self._up_mb(addr))

    def ref_idx_ctx(self, addr, bx, by, lst=0) -> int:
        """ref_idx_l<lst>'s context: neighbours with an index above 0,
        not counting I_PCM, skipped and direct-predicted ones."""
        pic = self.pic
        ref = pic.ref_idx if lst == 0 else pic.ref_idx_l1

        def term(nb):
            if nb is None:
                return 0
            naddr, nblk = nb
            q = (nblk // 8) * 2 + ((nblk % 4) // 2)
            if pic.mb_class[naddr] == MB_IPCM or pic.skip[naddr] \
                    or pic.b_direct[naddr] or pic.b8_direct[naddr, q]:
                return 0
            return 1 if ref[naddr, q] > 0 else 0

        return (2 * term(self._blk_neighbor(addr, bx, by - 1))
                + term(self._blk_neighbor(addr, bx - 1, by)))

    def mvd_ctx(self, addr, bx, by, comp, lst=0) -> int:
        """The first bin's context in mv_res[0]: from the sum of the
        neighbours' |mvd| of list lst (spec Table 9-39, ucoff 3 / 32)."""
        pic = self.pic
        a = 0
        for nb in (self._blk_neighbor(addr, bx - 1, by),
                   self._blk_neighbor(addr, bx, by - 1)):
            if nb is not None:
                a += abs(int(pic.mvd[nb[0], lst, nb[1], comp]))
        return 5 * comp + (0 if a < 3 else 3 if a > 32 else 2)

    def cbp_luma_ctx(self, addr, mb_x, mb_y, part) -> int:
        """The context of the luma cbp bin of 8x8 block (mb_x, mb_y) in
        {0, 2}^2; part: the luma cbp bits coded so far in this MB."""
        pic = self.pic
        if mb_y == 0:
            ua = self._up_mb(addr)
            b = 2 if (ua >= 0 and pic.mb_class[ua] != MB_IPCM
                      and (int(pic.cbp[ua])
                           & (1 << (2 + (mb_x >> 1)))) == 0) else 0
        else:
            b = 2 if (part & (1 << (mb_x >> 1))) == 0 else 0
        if mb_x == 0:
            a = 0
            nb = self._blk_neighbor(addr, -1, mb_y)
            if nb is not None and pic.mb_class[nb[0]] != MB_IPCM:
                a = 1 if (int(pic.cbp[nb[0]])
                          & (1 << (2 * (nb[1] // 8) + 1))) == 0 else 0
        else:
            a = 1 if (part & (1 << mb_y)) == 0 else 0
        return a + b

    def cbp_chroma_ctx(self, addr, second: bool) -> int:
        """The chroma cbp bin's context: first bin (any chroma), second
        (AC as well)."""
        pic = self.pic

        def term(n):
            if n < 0:
                return 0
            if pic.mb_class[n] == MB_IPCM:
                return 1
            c = int(pic.cbp[n])
            return 1 if ((c >> 4) == 2 if second else c > 15) else 0

        return (2 * term(self._up_mb(addr))
                + term(self._left_mb(addr)))

    def transform_size_ctx(self, addr) -> int:
        """transform_size_8x8_flag: the left and upper MBs' flags."""
        la, ua = self._left_mb(addr), self._up_mb(addr)
        t8 = self.pic.transform8x8
        return int(la >= 0 and t8[la]) + int(ua >= 0 and t8[ua])

    def mark_8x8(self, addr, blk8, coeff) -> None:
        """A coded 8x8 block stands for its four 4x4 blocks in the
        coded_block_flag bits that later contexts read (JM's 0x33
        pattern)."""
        if np.any(coeff):
            self.pic.cbp_bits[addr] |= np.int64(0x33) << (
                1 + (blk8 // 2) * 8 + (blk8 % 2) * 2)

    def cbf_ctx(self, addr, block_type, bx=0, by=0, comp=0):
        """coded_block_flag: (context 2 upper + left from the neighbours'
        bits, this block's bit in pic.cbp_bits)."""
        pic = self.pic
        default = 1 if pic.mb_class[addr] != MB_INTER else 0

        def nbit(naddr, bit):
            if pic.mb_class[naddr] == MB_IPCM:
                return 1
            return (int(pic.cbp_bits[naddr]) >> bit) & 1

        if block_type == LUMA_16DC:
            ub = lb = 1
            la, ua = self._left_mb(addr), self._up_mb(addr)
            if ua >= 0:
                ub = nbit(ua, 0)
            if la >= 0:
                lb = nbit(la, 0)
            bit0 = 0
        elif block_type in (LUMA_16AC, LUMA_4x4):
            ub = lb = default
            nb = self._blk_neighbor(addr, bx, by - 1)
            na = self._blk_neighbor(addr, bx - 1, by)
            if nb is not None:
                ub = nbit(nb[0], 1 + nb[1])
            if na is not None:
                lb = nbit(na[0], 1 + na[1])
            bit0 = 1 + by * 4 + bx
        elif block_type in (CHROMA_DC, CHROMA_DC_2x4):
            ub = lb = default
            bit0 = 17 if comp == 0 else 18
            la, ua = self._left_mb(addr), self._up_mb(addr)
            if ua >= 0:
                ub = nbit(ua, bit0)
            if la >= 0:
                lb = nbit(la, bit0)
        elif block_type == CHROMA_AC:
            ub = lb = default
            base = 19 if comp == 0 else 35
            nb = self._cblk_neighbor(addr, bx, by - 1)
            na = self._cblk_neighbor(addr, bx - 1, by)
            if nb is not None:
                ub = nbit(nb[0], base + 4 * (nb[1] // 2) + nb[1] % 2)
            if na is not None:
                lb = nbit(na[0], base + 4 * (na[1] // 2) + na[1] % 2)
            bit0 = base + 4 * by + bx
        else:
            raise NotImplementedError(f"cbf for block type {block_type}")
        return 2 * ub + lb, bit0


class MBParserCABAC(CabacNeighbours):
    """Serial CABAC slice-data parser filling a PictureData."""

    def __init__(self, pic: PictureData, ctx: SliceContext, br: BitReader,
                 native: bool = True):
        """native=False: the Python twin PyCabacEngine (which reads any
        reader); the native engine needs a native BitReader."""
        super().__init__(pic)
        self.ctx = ctx
        self.qp = ctx.qp
        self._engine = CabacEngine if native else PyCabacEngine
        N.routes["cabac"]["native" if native else "python"] += 1
        self.eng = self._engine(br)
        self.ctxs = CabacContexts(ctx.header.slice_type == SliceType.I,
                                  ctx.header.cabac_init_idc, ctx.qp)
        self.last_dquant = 0

    # ---- element readers --------------------------------------------------

    def read_mb_type_i(self, addr) -> int:
        """0 = I_NxN, 1..24 = I_16x16, 25 = I_PCM."""
        eng, ctx = self.eng, self.ctxs.mb_type[0]
        if not eng.decision(ctx, self.mb_type_i_ctx(addr)):
            return 0
        if eng.terminate():
            return 25
        sym = 1
        sym += eng.decision(ctx, 4) * 12
        if eng.decision(ctx, 5):
            sym += 8 if eng.decision(ctx, 6) else 4
        sym += eng.decision(ctx, 7) * 2
        sym += eng.decision(ctx, 8)
        return sym

    def read_mb_type_p(self) -> int:
        """JM's P mb_type: 1 = 16x16, 2 = 16x8, 3 = 8x16, 4 = P8x8,
        6 = I_NxN, 7..30 = I_16x16, 31 = I_PCM."""
        eng, ctx = self.eng, self.ctxs.mb_type[1]
        if eng.decision(ctx, 4):
            sym = 7 if eng.decision(ctx, 7) else 6
        elif eng.decision(ctx, 5):
            sym = 2 if eng.decision(ctx, 7) else 3
        else:
            sym = 4 if eng.decision(ctx, 6) else 1
        if sym <= 6:
            return sym
        if eng.terminate():
            return 31
        sym += eng.decision(ctx, 8) * 12
        if eng.decision(ctx, 9):
            sym += 4
            if eng.decision(ctx, 9):
                sym += 4
        sym += eng.decision(ctx, 10) * 2
        sym += eng.decision(ctx, 10)
        return sym

    def read_mb_type_b(self, addr) -> int:
        """B mb_type (readMB_typeInfo_CABAC_b_slice): 0 B_Direct_16x16,
        1..21 the partitions, 22 B_8x8, 23 I_NxN, 24..47 I_16x16, 48
        I_PCM."""
        eng, ctx = self.eng, self.ctxs.mb_type[2]
        if not eng.decision(ctx, self.mb_type_b_ctx(addr)):
            return 0
        if not eng.decision(ctx, 4):
            return 2 if eng.decision(ctx, 6) else 1
        if not eng.decision(ctx, 5):
            sym = 3 + 4 * eng.decision(ctx, 6)
            sym += 2 * eng.decision(ctx, 6)
            return sym + eng.decision(ctx, 6)
        sym = 12 + 8 * eng.decision(ctx, 6)
        sym += 4 * eng.decision(ctx, 6)
        sym += 2 * eng.decision(ctx, 6)
        if sym == 24:
            return 11
        if sym == 26:
            return 22
        if sym == 22:
            sym = 23
        sym += eng.decision(ctx, 6)
        if sym <= 23:                   # 12..21 inter, 23 I_NxN
            return sym
        if eng.terminate():             # 24: I_16x16 or I_PCM
            return 48
        ctx1 = self.ctxs.mb_type[1]
        sym += eng.decision(ctx1, 8) * 12
        if eng.decision(ctx1, 9):
            sym += 4
            if eng.decision(ctx1, 9):
                sym += 4
        sym += eng.decision(ctx1, 10) * 2
        return sym + eng.decision(ctx1, 10)

    def read_sub_mb_type_b(self) -> int:
        """B sub_mb_type 0..12 (readB8_typeInfo_CABAC_b_slice)."""
        eng, ctx = self.eng, self.ctxs.b8_type[1]
        if not eng.decision(ctx, 0):
            return 0
        if not eng.decision(ctx, 1):
            return 2 if eng.decision(ctx, 3) else 1
        if eng.decision(ctx, 2):
            if eng.decision(ctx, 3):
                return 11 + eng.decision(ctx, 3)
            sym = 7 + 2 * eng.decision(ctx, 3)
        else:
            sym = 3 + 2 * eng.decision(ctx, 3)
        return sym + eng.decision(ctx, 3)

    def read_sub_mb_type_p(self) -> int:
        """0 = 8x8, 1 = 8x4, 2 = 4x8, 3 = 4x4."""
        eng, ctx = self.eng, self.ctxs.b8_type[0]
        if eng.decision(ctx, 1):
            return 0
        if eng.decision(ctx, 3):
            return 2 if eng.decision(ctx, 4) else 3
        return 1

    def read_transform_size(self, addr) -> bool:
        return bool(self.eng.decision(self.ctxs.transform_size,
                                      self.transform_size_ctx(addr)))

    def read_intra4_mode(self) -> int:
        """-1 = the predicted mode, else rem (0..7, bins LSB first)."""
        eng, ctx = self.eng, self.ctxs.ipr
        if eng.decision(ctx, 0):
            return -1
        v = eng.decision(ctx, 1)
        v |= eng.decision(ctx, 1) << 1
        v |= eng.decision(ctx, 1) << 2
        return v

    def read_chroma_pred_mode(self, addr) -> int:
        sym = self.eng.decision(self.ctxs.cipr, self.chroma_mode_ctx(addr))
        if sym:
            sym = self.eng.unary_max(self.ctxs.cipr, 3, 3, 1) + 1
        return sym

    def read_ref_idx(self, addr, bx, by, lst=0) -> int:
        ctx = self.ctxs.ref_no[0]
        sym = self.eng.decision(ctx, self.ref_idx_ctx(addr, bx, by, lst))
        if sym:
            sym = self.eng.unary(ctx, 4, 5) + 1
        return sym

    def read_mvd(self, addr, bx, by, comp, lst=0) -> int:
        sym = self.eng.decision(self.ctxs.mv_res[0],
                                self.mvd_ctx(addr, bx, by, comp, lst))
        if sym:
            sym = self.eng.ueg3_mv(self.ctxs.mv_res[1], 5 * comp) + 1
            if self.eng.bypass():
                sym = -sym
        return sym

    def read_dquant(self) -> int:
        cidx = 1 if self.last_dquant != 0 else 0
        sym = self.eng.decision(self.ctxs.delta_qp, cidx)
        if sym:
            sym = self.eng.unary(self.ctxs.delta_qp, 2, 3) + 1
            dq = (sym + 1) >> 1
            if (sym & 1) == 0:
                dq = -dq
        else:
            dq = 0
        self.last_dquant = dq
        return dq

    def read_cbp(self, addr) -> int:
        eng = self.eng
        cbp = 0
        for mb_y in (0, 2):
            for mb_x in (0, 2):
                if eng.decision(self.ctxs.cbp[0],
                                self.cbp_luma_ctx(addr, mb_x, mb_y, cbp)):
                    cbp += 1 << (mb_y + (mb_x >> 1))
        if eng.decision(self.ctxs.cbp[1], self.cbp_chroma_ctx(addr, False)):
            cbp += 32 if eng.decision(self.ctxs.cbp[2],
                                      self.cbp_chroma_ctx(addr, True)) else 16
        return cbp

    # ---- residual blocks --------------------------------------------------

    def _read_block(self, addr, block_type, bx=0, by=0, comp=0):
        """Scan-order coefficients of one block, or None (cbf 0)."""
        ctx, bit0 = self.cbf_ctx(addr, block_type, bx, by, comp)
        if not self.eng.decision(self.ctxs.bcbp[TYPE2CTX_BCBP[block_type]],
                                 ctx):
            return None
        self.pic.cbp_bits[addr] |= np.int64(1) << bit0
        return read_significance_and_levels(self.eng, self.ctxs, block_type)

    def _read_luma_residual(self, addr, cbp, is_i16):
        pic = self.pic
        if is_i16:
            c = self._read_block(addr, LUMA_16DC)
            if c is not None:
                pic.luma_dc[addr] = c
        for blk8 in range(4):
            if not (cbp & (1 << blk8)):
                continue
            for sub in range(4):
                blk = int(CODE2RASTER[blk8 * 4 + sub])
                by, bx = divmod(blk, 4)
                if is_i16:
                    c = self._read_block(addr, LUMA_16AC, bx, by)
                    if c is not None:
                        pic.luma_coef[addr, blk, 1:16] = c
                else:
                    c = self._read_block(addr, LUMA_4x4, bx, by)
                    if c is not None:
                        pic.luma_coef[addr, blk] = c
                if c is not None:
                    pic.luma_nnz[addr, blk] = int(np.count_nonzero(c))

    def _read_luma_residual_8x8(self, addr, cbp):
        """Each coded 8x8 as one LUMA_8x8 block, always present; its
        count is the nnz of each of its 4x4 blocks."""
        for blk8 in range(4):
            if cbp & (1 << blk8):
                c = read_significance_and_levels(self.eng, self.ctxs,
                                                 LUMA_8x8)
                self.pic.luma_coef8[addr, blk8] = c
                self.mark_8x8(addr, blk8, c)
                b = (blk8 // 2) * 8 + (blk8 % 2) * 2
                self.pic.luma_nnz[addr, [b, b + 1, b + 4, b + 5]] = \
                    np.count_nonzero(c)

    def _read_chroma_residual(self, addr, cbp):
        pic = self.pic
        cbp_chroma = cbp >> 4
        dc_type = CHROMA_DC_2x4 if pic.n_crows == 4 else CHROMA_DC
        if cbp_chroma & 3:
            for comp in range(2):
                c = self._read_block(addr, dc_type, comp=comp)
                if c is not None:
                    pic.chroma_dc[addr, comp] = c
        if cbp_chroma & 2:
            for comp in range(2):
                for blk in range(2 * pic.n_crows):
                    by, bx = divmod(blk, 2)
                    c = self._read_block(addr, CHROMA_AC, bx, by, comp)
                    if c is not None:
                        pic.chroma_coef[addr, comp, blk, 1:16] = c
                        pic.chroma_nnz[addr, comp, blk] = \
                            int(np.count_nonzero(c))

    # ---- MB-level parse ---------------------------------------------------

    def _parse_ipcm(self, addr):
        """I_PCM (ldecod readIPCM_CABAC, init_decoding_engine_IPCM): the
        engine holds exactly a 9-bit window, so the reference's rewind
        reduces to aligning the reader, reading the 384 samples and
        restarting the arithmetic engine; the contexts are kept."""
        pic = self.pic
        br = self.eng.br
        ipcm_format_check(pic)
        pic.mb_class[addr] = MB_IPCM
        br.align()
        # bit_depth bits a sample (spec 7.3.5), where jm_tpu's CABAC parser
        # reads 8 (ROADMAP Queue 3)
        pic.ipcm_luma[addr], pic.ipcm_chroma[addr] = read_pcm_samples(
            br, self.ctx.sps)
        pic.qp[addr] = self.qp
        pic.luma_nnz[addr] = 16
        pic.chroma_nnz[addr] = 16
        self.last_dquant = 0
        self.eng = self._engine(br)

    def _parse_intra_mb(self, addr, imb_type):
        """imb_type: 0 = I_NxN, 1..24 = I_16x16, 25 = I_PCM."""
        pic = self.pic
        if imb_type == 25:
            self._parse_ipcm(addr)
            return
        if imb_type == 0:
            pic.mb_class[addr] = MB_I4
            if self.ctx.pps.transform_8x8_mode_flag:
                pic.transform8x8[addr] = self.read_transform_size(addr)
            t8 = pic.transform8x8[addr]
            # Intra8x8: one mode per quadrant, over its four 4x4 blocks
            for code_idx in range(0, 16, 4) if t8 else range(16):
                blk = int(CODE2RASTER[code_idx])
                pred = self.pctx.pred_intra4_mode(addr, blk)
                rem = self.read_intra4_mode()
                mode = pred if rem < 0 else (rem if rem < pred else rem + 1)
                for b in (blk, blk + 1, blk + 4, blk + 5) if t8 else (blk,):
                    pic.i4_modes[addr, b] = mode
            pic.chroma_mode[addr] = self.read_chroma_pred_mode(addr)
            cbp = self.read_cbp(addr)
            pic.cbp[addr] = cbp
            if cbp:
                self._apply_dquant(addr)
            else:
                self.last_dquant = 0
                pic.qp[addr] = self.qp
            if t8:
                self._read_luma_residual_8x8(addr, cbp & 15)
            else:
                self._read_luma_residual(addr, cbp & 15, is_i16=False)
        else:
            pic.mb_class[addr] = MB_I16
            k = imb_type - 1
            pic.i16_mode[addr] = k % 4
            cbp = ((k // 4) % 3) << 4 | (15 if k >= 12 else 0)
            pic.cbp[addr] = cbp
            pic.chroma_mode[addr] = self.read_chroma_pred_mode(addr)
            self._apply_dquant(addr)
            self._read_luma_residual(addr, cbp & 15, is_i16=True)
        self._read_chroma_residual(addr, cbp)

    def _apply_dquant(self, addr):
        self.qp = apply_qp_delta(self.qp, self.read_dquant(), self.ctx.sps)
        self.pic.qp[addr] = self.qp

    def _fill_mv(self, addr, bx, by, bw, bh, ref):
        """Read one partition's mvd pair, add its prediction, and store the
        MV and the mvd over the partition's 4x4 blocks."""
        pic = self.pic
        mvd = (self.read_mvd(addr, bx, by, 0), self.read_mvd(addr, bx, by, 1))
        mv = self.pctx.mv_pred(addr, bx, by, bw, bh, ref) + mvd
        for yy in range(by, by + bh):
            pic.mv[addr, yy * 4 + bx:yy * 4 + bx + bw] = mv
            pic.mvd[addr, 0, yy * 4 + bx:yy * 4 + bx + bw] = mvd

    def _parse_p_mb(self, addr, internal_type):
        """internal_type: 1 = 16x16, 2 = 16x8, 3 = 8x16, 4 = P8x8."""
        pic = self.pic
        nref = self.ctx.header.num_ref_idx_l0_active_minus1 + 1
        pic.mb_class[addr] = MB_INTER
        sub_types = ()
        if internal_type < 4:
            parts = _P_PARTS[internal_type - 1]
            refs = []
            for (bx, by, bw, bh) in parts:
                ref = self.read_ref_idx(addr, bx, by) if nref > 1 else 0
                refs.append(ref)
                # stored at once: the next read's context sees it
                for yy in range(by // 2, (by + bh) // 2):
                    for xx in range(bx // 2, (bx + bw) // 2):
                        pic.ref_idx[addr, yy * 2 + xx] = ref
            for (bx, by, bw, bh), ref in zip(parts, refs):
                self._fill_mv(addr, bx, by, bw, bh, ref)
        else:
            sub_types = [self.read_sub_mb_type_p() for _ in range(4)]
            pic.sub_mode[addr] = sub_types
            refs = [0] * 4
            for q in range(4):
                if nref > 1:
                    refs[q] = self.read_ref_idx(addr, (q % 2) * 2,
                                                (q // 2) * 2)
                pic.ref_idx[addr, q] = refs[q]
            for q in range(4):
                qx, qy = (q % 2) * 2, (q // 2) * 2
                for (sx, sy, sw, sh) in _SUB_PARTS[sub_types[q]]:
                    self._fill_mv(addr, qx + sx, qy + sy, sw, sh, refs[q])
        self._read_inter_residual(addr, p_allow8(internal_type - 1,
                                                 sub_types))

    def _parse_p_skip(self, addr):
        pic = self.pic
        pic.mb_class[addr] = MB_INTER
        pic.skip[addr] = True
        pic.ref_idx[addr] = 0
        pic.qp[addr] = self.qp
        pic.mv[addr] = self.pctx.skip_mv(addr)
        self.last_dquant = 0

    # ---- B MB ---------------------------------------------------------------

    def _parse_b_skip(self, addr):
        pic = self.pic
        pic.mb_class[addr] = MB_INTER
        pic.skip[addr] = True
        pic.b_direct[addr] = True
        pic.qp[addr] = self.qp
        B.fill_direct_mb(self, addr)
        self.last_dquant = 0

    def read_b_ref(self, addr, bx, by, lst):
        return self.read_ref_idx(addr, bx, by, lst)

    def read_b_mvd(self, addr, bx, by, lst):
        return (self.read_mvd(addr, bx, by, 0, lst),
                self.read_mvd(addr, bx, by, 1, lst))

    def _parse_b_mb(self, addr, coded):
        """coded: B mb_type 0 (B_Direct_16x16), 1..21, 22 (B_8x8)."""
        self.pic.mb_class[addr] = MB_INTER
        subs = []

        def read_subs():
            subs.extend(self.read_sub_mb_type_b() for _ in range(4))
            return subs

        B.parse_b_motion(self, addr, coded, read_subs)
        self._read_inter_residual(addr, b_allow8(coded, subs, self.ctx.sps))

    def _read_inter_residual(self, addr, allow8):
        """coded_block_pattern, transform_size_8x8_flag (when the PPS has
        the 8x8 transform, luma is coded and allow8), mb_qp_delta and the
        residual of an inter MB."""
        pic = self.pic
        cbp = self.read_cbp(addr)
        pic.cbp[addr] = cbp
        if self.ctx.pps.transform_8x8_mode_flag and cbp & 15 and allow8:
            pic.transform8x8[addr] = self.read_transform_size(addr)
        if cbp:
            self._apply_dquant(addr)
        else:
            self.last_dquant = 0
            pic.qp[addr] = self.qp
        if pic.transform8x8[addr]:
            self._read_luma_residual_8x8(addr, cbp & 15)
        else:
            self._read_luma_residual(addr, cbp & 15, is_i16=False)
        self._read_chroma_residual(addr, cbp)

    # ---- slice loop -------------------------------------------------------

    def parse_slice_data(self) -> None:
        h = self.ctx.header
        pic = self.pic
        addr = h.first_mb_in_slice
        n = pic.n_mbs
        sid = self.ctx.slice_id
        if addr >= n:
            raise ValueError(f"first_mb_in_slice {addr} outside the picture")
        is_b = h.slice_type == SliceType.B
        if is_b:
            N.routes["b"]["parse"] += 1
        while True:
            pic.slice_id[addr] = sid
            if h.slice_type == SliceType.SP:
                # jm_tpu's CABAC parser reads no SP slice either
                # (jm_tpu/decoder/mb_parse_cabac.py:851)
                raise NotImplementedError(
                    "out of scope: SP slices under CABAC")
            if h.slice_type == SliceType.I:
                self._parse_intra_mb(addr, self.read_mb_type_i(addr))
            elif is_b:
                if self.eng.decision(self.ctxs.mb_type[2],
                                     7 + self.skip_ctx(addr)):
                    self._parse_b_skip(addr)
                else:
                    t = self.read_mb_type_b(addr)
                    if t <= 22:
                        self._parse_b_mb(addr, t)
                    else:
                        self._parse_intra_mb(addr, 25 if t == 48 else t - 23)
            elif self.eng.decision(self.ctxs.mb_type[1],
                                   self.skip_ctx(addr)):
                self._parse_p_skip(addr)
            else:
                t = self.read_mb_type_p()
                if t <= 4:
                    self._parse_p_mb(addr, t)
                elif t == 31:
                    self._parse_intra_mb(addr, 25)
                else:
                    self._parse_intra_mb(addr, t - 6)
            addr = self.ctx.next_mb(addr)
            if self.eng.terminate() or addr >= n:
                break
