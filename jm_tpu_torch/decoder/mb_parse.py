"""Macroblock-layer parsing of CAVLC I, P and B slices (spec 7.3.5,
7.4.5, 9.2), twin of the Python path of jm_tpu/decoder/mb_parse.py for
4:2:0 and 4:2:2 frame pictures of 8 to 14 bits (the QP wraps over
[-QpBdOffsetY, 51], I_PCM samples take bit_depth bits) with the 4x4 and the adaptive 8x8
transform (transform_size_8x8_flag after an I_NxN mb_type, or after the
cbp of an inter MB with luma coefficients whose partitions are all 8x8
or larger; an 8x8 block is read as four 4x4 blocks interleaved, each
with its own nnz, ldecod read_comp_cavlc.c read_comp_coeff_8x8_CAVLC).

The serial parse walks the MBs of a slice in raster order and fills the
picture-wide SoA arrays of common/picture.PictureData (modes, MVs,
levels, nnz); reconstruction reads them as a whole. Neighbour-dependent
predictors (nC, intra 4x4 mode, median MV, P_Skip MV) come from
common/predict_ctx.PredCtx, the same code the encoder uses
(ldecod/src/mb_read.c read_one_macroblock_i_slice_cavlc:1139,
read_one_macroblock_p_slice_cavlc:1335; lcommon/src/mv_prediction.c).

A 4:2:2 picture's chroma residual is a 2x4 DC read with nC -2 and 8 AC
blocks per component; its CAVLC I / P slices are parsed in Python, as
in jm_tpu (mb_parse.py:597), and counted in native.routes["yuv422"].

An SP slice is parsed as a P slice (by the native parser unless as
below) and its MBs marked after; native.routes["sp"]["parse"] counts the
SP slices, each also counted under its route.

A B slice's MBs (B_Skip and B_Direct_16x16 with decoder/b_slice's
direct motion, the 16x16 / 16x8 / 8x16 partitions of list 0, list 1 or
both, B_8x8 with direct 8x8s) are parsed in Python, as in jm_tpu, and
counted in native.routes["b"]["parse"]. Any other slice is parsed by the
native parser of the port's C++ runtime (jm_tpu_torch/native, jm_dec.cpp
parse_slice_cavlc) unless the caller asks for the Python parser
(``native=False``) or the slice is data-partitioned; the C parser stops
at an I_PCM MB, and the Python parser
then reads the slice again from its start (jm_tpu/decoder/mb_parse.py
_parse_native). A data-partitioned slice (``dp_mode``) reads its MB
headers from partition A (``br``) and the residual of intra MBs from
partition B (``br_b``), of inter MBs from partition C (``br_c``);
a residual whose partition is missing raises ValueError.
native.routes["parse"] counts each slice's route, and
native.routes["dp"]["parse"] the partitioned ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native as N
from ..bitstream.bitreader import BitReader
from ..common.picture import (CBP_MAP_CHROMA, MB_I4, MB_I16, MB_INTER,
                              MB_IPCM, PictureData)
from ..common.predict_ctx import CODE2RASTER, PredCtx
from ..common.types import PPS, SPS, SliceHeader, SliceType
from . import b_slice as B
from .cavlc import residual_block_cavlc

# P mb_type 0..2 partitions and P8x8 sub-partitions, as (bx, by, bw, bh)
# in 4x4 blocks
_P_PARTS = {0: [(0, 0, 4, 4)],
            1: [(0, 0, 4, 2), (0, 2, 4, 2)],
            2: [(0, 0, 2, 4), (2, 0, 2, 4)]}
_SUB_PARTS = {0: [(0, 0, 2, 2)],
              1: [(0, 0, 2, 1), (0, 1, 2, 1)],
              2: [(0, 0, 1, 2), (1, 0, 1, 2)],
              3: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)]}


def p_allow8(mb_type: int, sub_types) -> bool:
    """Whether a P MB of mb_type 0..4 may carry transform_size_8x8_flag:
    no partition below 8x8 (spec 7.3.5)."""
    return mb_type < 3 or not any(sub_types)


def b_allow8(coded: int, subs, sps: SPS) -> bool:
    """Whether a coded B MB (mb_type 0..22; subs: a B_8x8's sub_mb_types)
    may carry transform_size_8x8_flag: a direct prediction only under
    direct_8x8_inference_flag, and no partition below 8x8 (spec 7.3.5)."""
    if coded == 0:
        return bool(sps.direct_8x8_inference_flag)
    if coded != 22:
        return True
    return all(t <= 3 for t in subs) and (
        bool(sps.direct_8x8_inference_flag) or all(t != 0 for t in subs))


def ipcm_format_check(pic: PictureData) -> None:
    """An I_PCM MB of a 4:2:2 picture raises, as jm_tpu's parser does
    (jm_tpu/decoder/mb_parse.py:339), although jm_tpu's encoder writes
    such MBs (ROADMAP Queue 3)."""
    if pic.n_crows != 2:
        raise NotImplementedError(
            "out of scope: I_PCM at chroma_format_idc 2")


def apply_qp_delta(qp: int, dq: int, sps: SPS) -> int:
    """QPY after an mb_qp_delta (spec 7.4.5): the modular wrap over
    [-QpBdOffsetY, 51], with jm_tpu's range check of the delta
    (jm_tpu/decoder/mb_parse.py _read_qp_delta)."""
    off = 6 * sps.bit_depth_luma_minus8              # QpBdOffsetY
    if not -(27 + off // 2) <= dq <= 26 + off // 2:
        raise ValueError(f"mb_qp_delta {dq} out of range")
    return (qp + dq + 52 + 2 * off) % (52 + off) - off


def read_pcm_samples(br: BitReader, sps: SPS):
    """The 256 luma and 2 x 64 chroma samples of a 4:2:0 I_PCM MB from a
    byte-aligned reader, of bit_depth bits each (spec 7.3.5): (luma
    (16, 16), chroma (2, 8, 8)), uint8 at 8 bits, else uint16."""
    bdl, bdc = sps.bit_depth_luma, sps.bit_depth_chroma
    if br.pos + 256 * bdl + 128 * bdc > br.nbits:
        raise EOFError("bitreader overrun in I_PCM samples")
    if bdl == bdc == 8:
        samples = np.frombuffer(br.data, np.uint8, 384, br.pos >> 3)
        br.pos += 384 * 8
        return (samples[:256].reshape(16, 16).copy(),
                samples[256:].reshape(2, 8, 8).copy())
    luma = np.array([br.u(bdl) for _ in range(256)], np.uint16)
    chroma = np.array([br.u(bdc) for _ in range(128)], np.uint16)
    return luma.reshape(16, 16), chroma.reshape(2, 8, 8)


@dataclass
class SliceContext:
    header: SliceHeader
    sps: SPS
    pps: PPS
    slice_id: int
    qp: int = 0
    # FMO: mb_succ[addr] is the next MB of addr's slice group
    # (common/fmo.next_mb_arrays); None: raster order (one slice group)
    mb_succ: object = None
    # B slices: the co-located picture's motion (b_slice.ColMotion) and
    # temporal direct's (list-0 uid -> index, long-term flags, scale
    # factors), set by the decoder
    b_col: object = None
    b_tdirect: object = None

    def __post_init__(self) -> None:
        self.qp = self.header.qp(self.pps)

    def next_mb(self, addr: int) -> int:
        return addr + 1 if self.mb_succ is None else int(self.mb_succ[addr])


class MBParser:
    """Serial CAVLC slice-data parser filling a PictureData."""

    def __init__(self, pic: PictureData, ctx: SliceContext, br: BitReader,
                 native: bool = True):
        self.pic = pic
        self.ctx = ctx
        self.br = br
        self.qp = ctx.qp
        self.pctx = PredCtx(pic)
        self.native = native
        # data partitioning: the readers of partitions B and C (None when
        # the partition is absent)
        self.dp_mode = False
        self.br_b = None
        self.br_c = None

    # ---- residual reading -------------------------------------------------

    def _res_br(self, addr: int):
        """The reader of this MB's residual: partition B for intra MBs, C
        for inter MBs, the slice's own reader without partitions."""
        if not self.dp_mode:
            return self.br
        br = self.br_b if self.pic.mb_class[addr] != MB_INTER else self.br_c
        if br is None:
            raise ValueError("missing data partition for residual data")
        return br

    def _read_luma_residual(self, addr: int, cbp: int, is_i16: bool) -> None:
        pic, br, pctx = self.pic, self._res_br(addr), self.pctx
        if is_i16:
            pic.luma_dc[addr], _tc = residual_block_cavlc(
                br, pctx.nc_luma(addr, 0), 16)
        for blk8 in range(4):
            if not (cbp & (1 << blk8)):
                continue
            for sub in range(4):
                blk = int(CODE2RASTER[blk8 * 4 + sub])
                nc = pctx.nc_luma(addr, blk)
                if is_i16:
                    out = np.zeros(16, np.int32)
                    out[1:16], tc = residual_block_cavlc(br, nc, 15)
                else:
                    out, tc = residual_block_cavlc(br, nc, 16)
                pic.luma_coef[addr, blk] = out
                pic.luma_nnz[addr, blk] = tc

    def _read_luma_residual_8x8(self, addr: int, cbp: int) -> None:
        """Each coded 8x8 as four interleaved 4x4 CAVLC blocks: the k-th
        coefficient of 4x4 block sub is the 8x8's scan position 4 k + sub
        (jm_tpu mb_parse.py _read_luma_residual_8x8)."""
        pic, br, pctx = self.pic, self._res_br(addr), self.pctx
        for blk8 in range(4):
            if not (cbp & (1 << blk8)):
                continue
            by0, bx0 = (blk8 // 2) * 2, (blk8 % 2) * 2
            for sub in range(4):
                blk = (by0 + sub // 2) * 4 + bx0 + sub % 2
                coeffs, tc = residual_block_cavlc(br, pctx.nc_luma(addr, blk),
                                                  16)
                pic.luma_nnz[addr, blk] = tc
                pic.luma_coef8[addr, blk8, sub::4] = coeffs

    def _read_i8_modes(self, addr: int) -> None:
        """The four Intra8x8 modes, each stored over its quadrant's 4x4
        blocks."""
        pic, br = self.pic, self.br
        for q in range(4):
            blk = (q // 2) * 8 + (q % 2) * 2
            pred = self.pctx.pred_intra4_mode(addr, blk)
            if br.flag():
                mode = pred
            else:
                rem = br.u(3)
                mode = rem if rem < pred else rem + 1
            for b in (blk, blk + 1, blk + 4, blk + 5):
                pic.i4_modes[addr, b] = mode

    def _read_chroma_residual(self, addr: int, cbp: int) -> None:
        """The chroma DC (2x2 with nC -1 at 4:2:0, 2x4 with nC -2 at
        4:2:2), then 2 n_crows AC blocks per component."""
        pic, br = self.pic, self._res_br(addr)
        cbp_chroma = cbp >> 4
        n_dc = 2 * pic.n_crows
        if cbp_chroma & 3:
            for comp in range(2):
                pic.chroma_dc[addr, comp], _tc = residual_block_cavlc(
                    br, -1 if n_dc == 4 else -2, n_dc)
        if cbp_chroma & 2:
            for comp in range(2):
                for blk in range(n_dc):
                    nc = self.pctx.nc_chroma(addr, comp, blk)
                    ac, tc = residual_block_cavlc(br, nc, 15)
                    pic.chroma_coef[addr, comp, blk, 1:16] = ac
                    pic.chroma_nnz[addr, comp, blk] = tc

    def _read_qp_delta(self, addr: int) -> None:
        self.qp = apply_qp_delta(self.qp, self.br.se(), self.ctx.sps)
        self.pic.qp[addr] = self.qp

    # ---- intra MB ---------------------------------------------------------

    def _parse_intra_mb(self, addr: int, imb_type: int) -> None:
        """imb_type: 0 = I_NxN, 1..24 = I_16x16, 25 = I_PCM."""
        pic, br = self.pic, self.br
        if imb_type == 25:
            self._parse_ipcm(addr)
            return
        if imb_type == 0:
            pic.mb_class[addr] = MB_I4
            if self.ctx.pps.transform_8x8_mode_flag:
                pic.transform8x8[addr] = bool(br.flag())
            if pic.transform8x8[addr]:
                self._read_i8_modes(addr)
            else:
                for code_idx in range(16):
                    blk = int(CODE2RASTER[code_idx])
                    pred = self.pctx.pred_intra4_mode(addr, blk)
                    if br.flag():  # prev_intra4x4_pred_mode_flag
                        mode = pred
                    else:
                        rem = br.u(3)
                        mode = rem if rem < pred else rem + 1
                    pic.i4_modes[addr, blk] = mode
            pic.chroma_mode[addr] = br.ue()
            cbp = int(CBP_MAP_CHROMA[br.ue()][0])
            pic.cbp[addr] = cbp
            if cbp:
                self._read_qp_delta(addr)
            else:
                pic.qp[addr] = self.qp
            if pic.transform8x8[addr]:
                self._read_luma_residual_8x8(addr, cbp & 15)
            else:
                self._read_luma_residual(addr, cbp, is_i16=False)
        else:
            pic.mb_class[addr] = MB_I16
            k = imb_type - 1
            pic.i16_mode[addr] = k % 4
            cbp = ((k // 4) % 3) << 4 | (15 if k >= 12 else 0)
            pic.cbp[addr] = cbp
            pic.chroma_mode[addr] = br.ue()
            self._read_qp_delta(addr)
            self._read_luma_residual(addr, cbp & 15, is_i16=True)
        self._read_chroma_residual(addr, cbp)

    def _parse_ipcm(self, addr: int) -> None:
        pic, br = self.pic, self.br
        ipcm_format_check(pic)
        pic.mb_class[addr] = MB_IPCM
        br.align()
        pic.ipcm_luma[addr], pic.ipcm_chroma[addr] = read_pcm_samples(
            br, self.ctx.sps)
        pic.qp[addr] = self.qp
        # PCM MBs count as 16 nnz for nC prediction and bS
        pic.luma_nnz[addr] = 16
        pic.chroma_nnz[addr] = 16

    # ---- inter MB (P slices) ---------------------------------------------

    def _fill_mv(self, addr, bx, by, bw, bh, ref) -> None:
        """Read one partition's mvd, add its prediction and store the MV
        over the partition's 4x4 blocks."""
        br = self.br
        mvd = np.array([br.se(), br.se()], np.int32)
        mv = self.pctx.mv_pred(addr, bx, by, bw, bh, ref) + mvd
        for yy in range(by, by + bh):
            self.pic.mv[addr, yy * 4 + bx:yy * 4 + bx + bw] = mv

    def _parse_p_mb(self, addr: int, mb_type: int) -> None:
        if mb_type >= 5:
            self._parse_intra_mb(addr, mb_type - 5)
            return
        pic, br = self.pic, self.br
        nref = self.ctx.header.num_ref_idx_l0_active_minus1 + 1
        pic.mb_class[addr] = MB_INTER
        sub_types = ()
        if mb_type < 3:
            parts = _P_PARTS[mb_type]
            refs = [br.te(nref - 1) if nref > 1 else 0 for _ in parts]
            for (bx, by, bw, bh), ref in zip(parts, refs):
                for yy in range(by // 2, (by + bh) // 2):
                    for xx in range(bx // 2, (bx + bw) // 2):
                        pic.ref_idx[addr, yy * 2 + xx] = ref
            for (bx, by, bw, bh), ref in zip(parts, refs):
                self._fill_mv(addr, bx, by, bw, bh, ref)
        else:
            sub_types = [br.ue() for _ in range(4)]
            if any(t > 3 for t in sub_types):
                raise ValueError("invalid sub_mb_type")
            pic.sub_mode[addr] = sub_types
            refs = [0, 0, 0, 0]
            if mb_type == 3 and nref > 1:        # P_8x8ref0 keeps ref 0
                refs = [br.te(nref - 1) for _ in range(4)]
            pic.ref_idx[addr] = refs
            for q in range(4):
                qx, qy = (q % 2) * 2, (q // 2) * 2
                for (sx, sy, sw, sh) in _SUB_PARTS[sub_types[q]]:
                    self._fill_mv(addr, qx + sx, qy + sy, sw, sh, refs[q])

        self._read_inter_residual(addr, p_allow8(mb_type, sub_types))

    def _read_inter_residual(self, addr: int, allow8: bool) -> None:
        """coded_block_pattern, transform_size_8x8_flag (when the PPS has
        the 8x8 transform, luma is coded and allow8), mb_qp_delta and the
        residual of an inter MB."""
        pic = self.pic
        cbp = int(CBP_MAP_CHROMA[self.br.ue()][1])
        pic.cbp[addr] = cbp
        self._maybe_read_inter_transform8x8(addr, cbp, allow8)
        if cbp:
            self._read_qp_delta(addr)
        else:
            pic.qp[addr] = self.qp
        if pic.transform8x8[addr]:
            self._read_luma_residual_8x8(addr, cbp & 15)
        else:
            self._read_luma_residual(addr, cbp & 15, is_i16=False)
        self._read_chroma_residual(addr, cbp)

    def _maybe_read_inter_transform8x8(self, addr: int, cbp: int,
                                       allow8: bool) -> None:
        """transform_size_8x8_flag of an inter MB, when the PPS has the
        8x8 transform, luma is coded and allow8."""
        if self.ctx.pps.transform_8x8_mode_flag and cbp & 15 and allow8:
            self.pic.transform8x8[addr] = bool(self.br.flag())

    def _parse_p_skip(self, addr: int) -> None:
        """P_Skip: ref 0 and the skip MV prediction (spec 8.4.1.1)."""
        pic = self.pic
        pic.mb_class[addr] = MB_INTER
        pic.skip[addr] = True
        pic.ref_idx[addr] = 0
        pic.qp[addr] = self.qp
        pic.mv[addr] = self.pctx.skip_mv(addr)

    # ---- B MB (B slices) --------------------------------------------------

    def _parse_b_skip(self, addr: int) -> None:
        pic = self.pic
        pic.mb_class[addr] = MB_INTER
        pic.skip[addr] = True
        pic.b_direct[addr] = True
        pic.qp[addr] = self.qp
        B.fill_direct_mb(self, addr)

    def read_b_ref(self, addr, bx, by, lst) -> int:
        h = self.ctx.header
        n = (h.num_ref_idx_l1_active_minus1 if lst
             else h.num_ref_idx_l0_active_minus1)
        return self.br.te(n)

    def read_b_mvd(self, addr, bx, by, lst):
        return self.br.se(), self.br.se()

    def _read_b_subs(self):
        subs = [self.br.ue() for _ in range(4)]
        if any(t > 12 for t in subs):
            raise ValueError("invalid B sub_mb_type")
        self._b_subs = subs
        return subs

    def _parse_b_mb(self, addr: int, coded: int) -> None:
        """coded: B mb_type 0 (B_Direct_16x16), 1..21, 22 (B_8x8)."""
        self.pic.mb_class[addr] = MB_INTER
        self._b_subs = ()
        B.parse_b_motion(self, addr, coded, self._read_b_subs)
        self._read_inter_residual(addr, b_allow8(coded, self._b_subs,
                                                 self.ctx.sps))

    # ---- native parse -----------------------------------------------------

    def _parse_native(self) -> bool:
        """Parse the slice with the native C parser (I/P CAVLC 4:2:0 at
        any bit depth: the parser wraps the QP over [-QpBdOffsetY, 51],
        where jm_tpu keeps >8-bit slices on its Python parser; with the
        FMO successor map when the PPS has slice groups). Returns False, with
        the reader where it was, when
        the parser stopped at an I_PCM MB: the arrays it filled so far
        are rewritten with the same values by the Python parser."""
        h, pic, br = self.ctx.header, self.pic, self.br
        params = {
            "first_mb": int(h.first_mb_in_slice),
            "n_mbs": pic.n_mbs,
            "mb_w": pic.mb_w,
            "stype": 0 if h.slice_type == SliceType.I else 1,
            "slice_id": self.ctx.slice_id,
            "qp": self.ctx.qp,
            "nref": h.num_ref_idx_l0_active_minus1 + 1,
            "t8": int(self.ctx.pps.transform_8x8_mode_flag),
            "qp_bd_offset": 6 * self.ctx.sps.bit_depth_luma_minus8,
        }
        arrays = {
            "mb_class": pic.mb_class, "skip": pic.skip,
            "transform8x8": pic.transform8x8, "i4_modes": pic.i4_modes,
            "i16_mode": pic.i16_mode, "chroma_mode": pic.chroma_mode,
            "cbp": pic.cbp, "qp": pic.qp, "slice_id": pic.slice_id,
            "luma_coef": pic.luma_coef, "luma_dc": pic.luma_dc,
            "chroma_dc": pic.chroma_dc, "chroma_coef": pic.chroma_coef,
            "luma_coef8": pic.luma_coef8, "luma_nnz": pic.luma_nnz,
            "chroma_nnz": pic.chroma_nnz, "mv": pic.mv,
            "ref_idx": pic.ref_idx, "sub_mode": pic.sub_mode,
            "succ": None if self.ctx.mb_succ is None else
            np.ascontiguousarray(self.ctx.mb_succ, np.int32),
        }
        status, pos = N.load().parse_slice_cavlc(br.data, br.pos, params,
                                                 arrays)
        if status:
            return False
        br.pos = pos
        return True

    # ---- slice loop -------------------------------------------------------

    def parse_slice_data(self) -> None:
        """Parse the slice's MBs into the picture; an SP slice's MB layer
        is a P slice's (spec 7.3.5), parsed as one, after which its MBs
        are marked (jm_tpu/decoder/mb_parse.py mark_sp, :662-668): its
        inter MBs take the SP reconstruction, every MB the SP bS, QS and
        sp_for_switch_flag of the slice."""
        self._parse_slice_mbs()
        h = self.ctx.header
        if h.slice_type != SliceType.SP:
            return
        N.routes["sp"]["parse"] += 1
        pic = self.pic
        m = pic.slice_id == self.ctx.slice_id
        pic.sp_mb[m] = pic.mb_class[m] == MB_INTER
        pic.sp_slice[m] = True
        pic.sp_qs[m] = h.qs(self.ctx.pps)
        pic.sp_switch[m] = bool(h.sp_for_switch_flag)

    def _parse_slice_mbs(self) -> None:
        h = self.ctx.header
        pic, br = self.pic, self.br
        addr = h.first_mb_in_slice
        n = pic.n_mbs
        sid = self.ctx.slice_id
        if addr >= n:
            raise ValueError(f"first_mb_in_slice {addr} outside the picture")
        is_b = h.slice_type == SliceType.B
        if self.dp_mode:
            N.routes["dp"]["parse"] += 1
        elif is_b:
            N.routes["b"]["parse"] += 1
        elif pic.n_crows != 2:
            N.routes["yuv422"]["parse"] += 1
        elif self.native:
            if self._parse_native():
                N.routes["parse"]["native"] += 1
                return
            N.routes["parse"]["rerun"] += 1
        else:
            N.routes["parse"]["python"] += 1
        nxt = self.ctx.next_mb
        if h.slice_type == SliceType.I:
            while True:
                pic.slice_id[addr] = sid
                self._parse_intra_mb(addr, br.ue())
                addr = nxt(addr)
                if addr >= n or not br.more_rbsp_data():
                    break
            return
        while addr < n:
            skip_run = br.ue()
            for _ in range(skip_run):
                if addr >= n:
                    raise ValueError("mb_skip_run past end of picture")
                pic.slice_id[addr] = sid
                if is_b:
                    self._parse_b_skip(addr)
                else:
                    self._parse_p_skip(addr)
                addr = nxt(addr)
            if addr >= n or not br.more_rbsp_data():
                break
            pic.slice_id[addr] = sid
            mb_type = br.ue()
            if not is_b:
                self._parse_p_mb(addr, mb_type)
            elif mb_type >= 23:
                self._parse_intra_mb(addr, mb_type - 23)
            else:
                self._parse_b_mb(addr, mb_type)
            addr = nxt(addr)
            if not br.more_rbsp_data():
                break
