"""Picture-wide macroblock state (SoA) shared by the encoder's decision
stages, the CAVLC and CABAC serializers and the decoder's slice parsers,
with the MB class codes and the coded_block_pattern table (spec Table
9-4)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# spec Table 9-4: coded_block_pattern mapping, codeNum -> (intra, inter)
# ChromaArrayType 1/2 (48 entries)
CBP_MAP_CHROMA = np.array([
    (47, 0), (31, 16), (15, 1), (0, 2), (23, 4), (27, 8), (29, 32), (30, 3),
    (7, 5), (11, 10), (13, 12), (14, 15), (39, 47), (43, 7), (45, 11), (46, 13),
    (16, 14), (3, 6), (5, 9), (10, 31), (12, 35), (19, 37), (21, 42), (26, 44),
    (28, 33), (35, 34), (37, 36), (42, 40), (44, 39), (1, 43), (2, 45), (4, 46),
    (8, 17), (17, 18), (18, 20), (20, 24), (24, 19), (6, 21), (9, 26), (22, 28),
    (25, 23), (32, 27), (33, 29), (34, 30), (36, 22), (40, 25), (38, 38),
    (41, 41),
], dtype=np.int32)

# MB-type classes
MB_INTER = 0
MB_I4 = 1
MB_I16 = 2
MB_IPCM = 3


@dataclass
class PictureData:
    """Per-picture macroblock state (SoA) of a 4:2:0 or 4:2:2 frame
    (chroma_format_idc 1 or 2), filled by the encoder's decisions and
    read by the serializers (encoder/syntax.py,
    encoder/syntax_cabac.py), or filled by the decoder's parsers
    (decoder/mb_parse.py, decoder/mb_parse_cabac.py) and read by its
    reconstruction."""
    mb_w: int
    mb_h: int
    chroma_format_idc: int = 1

    def __post_init__(self) -> None:
        n = self.mb_w * self.mb_h
        self.n_mbs = n
        # chroma 4x4-block rows per MB: 2 at 4:2:0, 4 at 4:2:2
        crows = 4 if self.chroma_format_idc == 2 else 2
        self.n_crows = crows
        # a field picture (decoded at half the frame's height): the field
        # scan of its 4x4 levels and the field rules of its deblock
        self.field_mode = False
        self.mb_class = np.zeros(n, np.int8)            # MB_* class
        self.skip = np.zeros(n, bool)
        self.transform8x8 = np.zeros(n, bool)           # 8x8 luma transform
        self.i4_modes = np.full((n, 16), -1, np.int8)   # raster block order
        self.i16_mode = np.full(n, -1, np.int8)
        self.chroma_mode = np.zeros(n, np.int8)
        self.cbp = np.zeros(n, np.int32)
        self.qp = np.zeros(n, np.int32)                 # absolute luma QP
        self.slice_id = np.full(n, -1, np.int32)
        # residuals in scan order
        self.luma_coef = np.zeros((n, 16, 16), np.int32)   # [mb][raster blk][scan]
        self.luma_dc = np.zeros((n, 16), np.int32)         # i16 DC, zigzag scan
        # 8x8-transform levels: [mb][8x8 quadrant][8x8 zig-zag scan]
        self.luma_coef8 = np.zeros((n, 4, 64), np.int32)
        self.chroma_dc = np.zeros((n, 2, 2 * crows), np.int32)   # scan order
        self.chroma_coef = np.zeros((n, 2, 2 * crows, 16), np.int32)
        # nnz per 4x4 block (raster in MB), for nC prediction; of an 8x8
        # block, each 4x4's interleaved count in CAVLC, the 8x8's in CABAC
        self.luma_nnz = np.zeros((n, 16), np.int32)
        self.chroma_nnz = np.zeros((n, 2, 2 * crows), np.int32)
        # motion: quarter-pel MVs per 4x4 raster block, refs per 8x8
        self.mv = np.zeros((n, 16, 2), np.int32)
        self.ref_idx = np.full((n, 4), -1, np.int8)        # -1 intra
        self.mv_l1 = np.zeros((n, 16, 2), np.int32)
        self.ref_idx_l1 = np.full((n, 4), -1, np.int8)
        self.sub_mode = np.zeros((n, 4), np.int8)          # P8x8 sub-partition
        self.inter_mode = np.full(n, -1, np.int8)          # P mb_type 0..3
        # per-8x8 prediction direction (0 list0, 1 list1, 2 both; -1
        # intra / not set)
        self.pdir = np.full((n, 4), -1, np.int8)
        # B direct prediction: the whole MB (B_Skip, B_Direct_16x16) or
        # one 8x8 of a B_8x8 MB (sub_mb_type B_Direct_8x8)
        self.b_direct = np.zeros(n, bool)
        self.b8_direct = np.zeros((n, 4), bool)
        # unique ids of the referenced pictures per 8x8 and list (bS)
        self.ref_pic_id = np.full((n, 4), -1, np.int64)
        self.ref_pic_id_l1 = np.full((n, 4), -1, np.int64)
        # SP slices (spec 8.6.1; jm_tpu/decoder/mb_parse.py:105-112): the
        # inter MBs of an SP slice (reconstructed by requantizing the
        # prediction plus residual at QS), every MB of an SP slice (bS
        # forced to 3 / 4), each MB's QS and sp_for_switch_flag
        self.sp_mb = np.zeros(n, bool)
        self.sp_slice = np.zeros(n, bool)
        self.sp_qs = np.zeros(n, np.int32)
        self.sp_switch = np.zeros(n, bool)
        # I_PCM samples by MB address: (16, 16) luma, (2, 4 crows, 8)
        # chroma
        self.ipcm_luma = {}
        self.ipcm_chroma = {}
        # CABAC context state: the mvd per list and 4x4 raster block, and
        # the coded_block_flag bits in JM's layout (ldecod cabac.c
        # s_cbp[0].bits: bit 0 luma DC, 1 + blk luma 4x4, 17 / 18 chroma
        # DC, 19 + 4 y + x Cb AC, 35 + 4 y + x Cr AC)
        self.mvd = np.zeros((n, 2, 16, 2), np.int32)
        self.cbp_bits = np.zeros(n, np.int64)
