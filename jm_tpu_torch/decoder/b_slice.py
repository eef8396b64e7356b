"""B-slice motion of the port, twin of jm_tpu/decoder/b_slice.py: the
mb_type and sub_mb_type semantics (spec Tables 7-14, 7-18), spatial and
temporal direct prediction with direct_8x8_inference_flag 1 (spec
8.4.1.2.2, 8.4.1.2.3), and the initial B reference lists (spec 8.2.4.2.3)
(ldecod/src/mc_direct.c update_direct_mv_info_spatial_8x8:382,
get_colocated_info_8x8:314; mbuffer.c init_lists_b_slice,
compute_colocated:2775).

Shared by the decoder's CAVLC and CABAC parsers (decoder/mb_parse.py,
decoder/mb_parse_cabac.py) and by the encoder's B macroblock coder
(encoder/b_host.py). Everything here is host numpy over the picture's
SoA arrays (common/picture.PictureData).
"""

from __future__ import annotations

import numpy as np

# prediction directions of an 8x8 (PictureData.pdir)
PD_L0, PD_L1, PD_BI, PD_DIRECT = 0, 1, 2, 3

# coded B mb_type 1..21 -> (partition shape, pdir of each partition)
B_MBTYPE = {
    1: ("16x16", (PD_L0,)), 2: ("16x16", (PD_L1,)), 3: ("16x16", (PD_BI,)),
    4: ("16x8", (PD_L0, PD_L0)), 5: ("8x16", (PD_L0, PD_L0)),
    6: ("16x8", (PD_L1, PD_L1)), 7: ("8x16", (PD_L1, PD_L1)),
    8: ("16x8", (PD_L0, PD_L1)), 9: ("8x16", (PD_L0, PD_L1)),
    10: ("16x8", (PD_L1, PD_L0)), 11: ("8x16", (PD_L1, PD_L0)),
    12: ("16x8", (PD_L0, PD_BI)), 13: ("8x16", (PD_L0, PD_BI)),
    14: ("16x8", (PD_L1, PD_BI)), 15: ("8x16", (PD_L1, PD_BI)),
    16: ("16x8", (PD_BI, PD_L0)), 17: ("8x16", (PD_BI, PD_L0)),
    18: ("16x8", (PD_BI, PD_L1)), 19: ("8x16", (PD_BI, PD_L1)),
    20: ("16x8", (PD_BI, PD_BI)), 21: ("8x16", (PD_BI, PD_BI)),
}
# the partitions of each shape, as (bx, by, bw, bh) in 4x4 blocks
B_PARTS = {"16x16": [(0, 0, 4, 4)],
           "16x8": [(0, 0, 4, 2), (0, 2, 4, 2)],
           "8x16": [(0, 0, 2, 4), (2, 0, 2, 4)]}

# coded B sub_mb_type 0..12 -> (sub-partition size (w, h) in 4x4 blocks,
# pdir); 0 is B_Direct_8x8
B_SUBTYPE = {
    0: (None, PD_DIRECT),
    1: ((2, 2), PD_L0), 2: ((2, 2), PD_L1), 3: ((2, 2), PD_BI),
    4: ((2, 1), PD_L0), 5: ((1, 2), PD_L0),
    6: ((2, 1), PD_L1), 7: ((1, 2), PD_L1),
    8: ((2, 1), PD_BI), 9: ((1, 2), PD_BI),
    10: ((1, 1), PD_L0), 11: ((1, 1), PD_L1), 12: ((1, 1), PD_BI),
}


def rsd(x: int) -> int:
    """The 4x4 block toward the 8x8 corner (lcommon ifunctions.h RSD)."""
    return (x | 1) if (x & 2) else (x & ~1)


class ColMotion:
    """The motion of the co-located picture (list1[0]) for direct
    prediction: per-4x4 MVs (n, 16, 2) and per-8x8 reference indices
    (n, 4) of both lists, and per-8x8 unique ids of the pictures they
    referenced (temporal direct)."""

    def __init__(self, mv0, ref0_q, mv1, ref1_q, mb_w, is_long_term,
                 refpic0_q=None, refpic1_q=None):
        self.mv0, self.ref0_q = mv0, ref0_q
        self.mv1, self.ref1_q = mv1, ref1_q
        self.refpic0_q, self.refpic1_q = refpic0_q, refpic1_q
        self.mb_w = mb_w
        self.is_long_term = is_long_term

    def _loc(self, gx: int, gy: int):
        addr = (gy // 4) * self.mb_w + (gx // 4)
        blk = (gy % 4) * 4 + (gx % 4)
        return addr, blk, (blk // 8) * 2 + ((blk % 4) // 2)

    def at(self, gx: int, gy: int):
        """(ref0, mv0, ref1, mv1) at global 4x4 block (gx, gy)."""
        addr, blk, q = self._loc(gx, gy)
        return (int(self.ref0_q[addr, q]), self.mv0[addr, blk],
                int(self.ref1_q[addr, q]), self.mv1[addr, blk])

    def at_full(self, gx: int, gy: int):
        """(list, ref_idx, referenced picture's uid, mvCol) for temporal
        direct: list 0 unless the block predicted from list 1 only."""
        addr, blk, q = self._loc(gx, gy)
        if int(self.ref0_q[addr, q]) != -1:
            return (0, int(self.ref0_q[addr, q]),
                    int(self.refpic0_q[addr, q]), self.mv0[addr, blk])
        return (1, int(self.ref1_q[addr, q]),
                int(self.refpic1_q[addr, q]), self.mv1[addr, blk])

    def col_zero(self, gx: int, gy: int) -> bool:
        """colZeroFlag (ldecod get_colocated_info_8x8 'is_not_moving')."""
        if self.is_long_term:
            return False
        r0, mv0, r1, mv1 = self.at(rsd(gx), rsd(gy))
        if r0 == 0 and (abs(int(mv0[0])) >> 1) == 0 \
                and (abs(int(mv0[1])) >> 1) == 0:
            return True
        return (r0 == -1 and r1 == 0 and (abs(int(mv1[0])) >> 1) == 0
                and (abs(int(mv1[1])) >> 1) == 0)


def prepare_direct_params(pctx, addr: int):
    """(refIdxL0, refIdxL1, mvpL0, mvpL1) of spatial direct for MB addr
    (spec 8.4.1.2.2): the least non-negative reference index of the
    neighbours A, B and C (D where C is unavailable) per list, and the
    16x16 MV prediction at that index."""
    def refs_of(bx, by, lst):
        nb = pctx.mv_neighbor(addr, bx, by, 0, lst)
        return -1 if nb is None else nb[1]

    def both_refs(bx, by):
        return refs_of(bx, by, 0), refs_of(bx, by, 1)

    a0, a1 = both_refs(-1, 0)
    b0, b1 = both_refs(0, -1)
    if pctx.mv_neighbor(addr, 4, -1, 0, 0) is None and \
            pctx.mv_neighbor(addr, 4, -1, 0, 1) is None:
        c0, c1 = both_refs(-1, -1)          # C unavailable: D
    else:
        c0, c1 = both_refs(4, -1)

    def min_pos(vals):
        # JM takes the minimum over unsigned char: -1 acts as +infinity
        m = min(v & 0xFF for v in vals)
        return m - 256 if m > 127 else m

    l0, l1 = min_pos([a0, b0, c0]), min_pos([a1, b1, c1])
    pmv0 = pctx.mv_pred(addr, 0, 0, 4, 4, l0, 0) if l0 >= 0 \
        else np.zeros(2, np.int32)
    pmv1 = pctx.mv_pred(addr, 0, 0, 4, 4, l1, 1) if l1 >= 0 \
        else np.zeros(2, np.int32)
    return l0, l1, pmv0, pmv1


def _fill_quadrant(pic, addr: int, q: int, mv0, mv1) -> None:
    qx, qy = (q % 2) * 2, (q // 2) * 2
    for yy in range(qy, qy + 2):
        pic.mv[addr, yy * 4 + qx:yy * 4 + qx + 2] = mv0
        pic.mv_l1[addr, yy * 4 + qx:yy * 4 + qx + 2] = mv1


def spatial_direct_quadrant(pic, addr: int, q: int, l0: int, l1: int,
                            pmv0, pmv1, col: ColMotion) -> None:
    """Spatial direct motion of 8x8 quadrant q of MB addr (8x8
    inference): reference indices, pdir and MVs into pic."""
    mbx, mby = addr % pic.mb_w, addr // pic.mb_w
    not_moving = col.col_zero(mbx * 4 + (q % 2) * 2, mby * 4 + (q // 2) * 2)
    zero = np.zeros(2, np.int32)
    if l0 < 0 and l1 < 0:
        r0, r1, mv0, mv1 = 0, 0, zero, zero
    else:
        r0, r1 = l0, l1
        mv0 = pmv0 if l0 >= 0 else zero
        mv1 = pmv1 if l1 >= 0 else zero
        if not_moving:
            if l0 == 0:
                mv0 = zero
            if l1 == 0:
                mv1 = zero
    pic.ref_idx[addr, q] = r0
    pic.ref_idx_l1[addr, q] = r1
    pic.pdir[addr, q] = PD_BI if r0 >= 0 and r1 >= 0 else (
        PD_L0 if r0 >= 0 else PD_L1)
    _fill_quadrant(pic, addr, q, mv0 if r0 >= 0 else zero,
                   mv1 if r1 >= 0 else zero)


def _c_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def compute_mvscale(cur_poc: int, list0, list1_0_poc: int) -> list[int]:
    """DistScaleFactor of each list-0 picture (ldecod mbuffer.c
    compute_colocated:2775); 9999: the MV is copied unscaled."""
    out = []
    for f in list0:
        trb = max(-128, min(127, cur_poc - f.poc))
        trp = max(-128, min(127, list1_0_poc - f.poc))
        if trp != 0:
            prescale = _c_div(16384 + abs(_c_div(trp, 2)), trp)
            out.append(max(-1024, min(1023, (trb * prescale + 32) >> 6)))
        else:
            out.append(9999)
    return out


def temporal_direct_quadrant(pic, addr: int, q: int, col: ColMotion,
                             list0_uid_to_idx: dict, list0_lt,
                             mvscale) -> None:
    """Temporal direct of 8x8 quadrant q of MB addr (8x8 inference, frame
    pictures). list0_uid_to_idx: picture uid -> index in the current
    list 0; list0_lt: long-term flag per index; mvscale: compute_mvscale's
    factors."""
    mbx, mby = addr % pic.mb_w, addr // pic.mb_w
    gx, gy = mbx * 4 + (q % 2) * 2, mby * 4 + (q // 2) * 2
    _lst, col_ref, col_uid, mv_col = col.at_full(rsd(gx), rsd(gy))
    pic.pdir[addr, q] = PD_BI
    zero = np.zeros(2, np.int32)
    if col_ref == -1:                     # co-located block intra
        pic.ref_idx[addr, q] = 0
        pic.ref_idx_l1[addr, q] = 0
        _fill_quadrant(pic, addr, q, zero, zero)
        return
    mapped = list0_uid_to_idx.get(col_uid)
    if mapped is None:
        raise ValueError("temporal direct: colocated reference unavailable")
    scale = mvscale[mapped]
    mvx, mvy = int(mv_col[0]), int(mv_col[1])
    if scale == 9999 or list0_lt[mapped]:
        m0, m1 = np.array([mvx, mvy], np.int32), zero
    else:
        m0 = np.array([(scale * mvx + 128) >> 8,
                       (scale * mvy + 128) >> 8], np.int32)
        m1 = m0 - (mvx, mvy)
    pic.ref_idx[addr, q] = mapped
    pic.ref_idx_l1[addr, q] = 0
    _fill_quadrant(pic, addr, q, m0, m1)


def direct_quadrant(parser, addr: int, q: int, direct_params=None) -> None:
    """Direct motion of one quadrant, spatial or temporal as the slice
    header says (parser: a slice parser with pic and ctx, ctx.b_col and
    ctx.b_tdirect set by the decoder)."""
    if parser.ctx.header.direct_spatial_mv_pred_flag:
        l0, l1, pmv0, pmv1 = direct_params
        spatial_direct_quadrant(parser.pic, addr, q, l0, l1, pmv0, pmv1,
                                parser.ctx.b_col)
    else:
        uid_to_idx, lt_flags, mvscale = parser.ctx.b_tdirect
        temporal_direct_quadrant(parser.pic, addr, q, parser.ctx.b_col,
                                 uid_to_idx, lt_flags, mvscale)
    parser.pic.b8_direct[addr, q] = True


def fill_direct_mb(parser, addr: int) -> None:
    """Direct motion of the whole MB (B_Skip, B_Direct_16x16)."""
    dp = (prepare_direct_params(parser.pctx, addr)
          if parser.ctx.header.direct_spatial_mv_pred_flag else None)
    for q in range(4):
        direct_quadrant(parser, addr, q, dp)


_USES = ((PD_L0, PD_BI), (PD_L1, PD_BI))     # the pdirs that use each list


def _store_refs(pic, addr, bx, by, bw, bh, lst, ref, pd) -> None:
    arr = pic.ref_idx if lst == 0 else pic.ref_idx_l1
    for yy in range(by // 2, (by + bh) // 2):
        for xx in range(bx // 2, (bx + bw) // 2):
            arr[addr, yy * 2 + xx] = ref
            pic.pdir[addr, yy * 2 + xx] = pd


def read_part_mvd(parser, addr, bx, by, bw, bh, lst, ref) -> None:
    """One partition's list-lst mvd added to its prediction; the MV and
    the mvd stored over the partition's 4x4 blocks."""
    pic = parser.pic
    mvd = parser.read_b_mvd(addr, bx, by, lst)
    mv = parser.pctx.mv_pred(addr, bx, by, bw, bh, ref, lst) + mvd
    mv_arr = pic.mv if lst == 0 else pic.mv_l1
    for yy in range(by, by + bh):
        mv_arr[addr, yy * 4 + bx:yy * 4 + bx + bw] = mv
        pic.mvd[addr, lst, yy * 4 + bx:yy * 4 + bx + bw] = mvd


def parse_b_motion(parser, addr: int, coded: int, read_subs) -> None:
    """The motion of a coded B MB (mb_type 0 B_Direct_16x16, 1..21 the
    partitions, 22 B_8x8), shared by the CAVLC and CABAC parsers in the
    syntax order of spec 7.3.5.1 / 7.3.5.2: the list-0 then list-1
    reference indices, then the list-0 then list-1 mvds. parser supplies
    read_b_ref(addr, bx, by, lst) and read_b_mvd(addr, bx, by, lst) ->
    (x, y); read_subs() reads the four sub_mb_types of a B_8x8. Each
    index is stored as it is read (a CABAC context reads it), and a
    B_Direct_8x8 takes its motion in the list-0 pass."""
    pic, h = parser.pic, parser.ctx.header
    nref = (h.num_ref_idx_l0_active_minus1 + 1,
            h.num_ref_idx_l1_active_minus1 + 1)

    def read_ref(bx, by, lst):
        return parser.read_b_ref(addr, bx, by, lst) if nref[lst] > 1 else 0

    if coded == 0:
        pic.b_direct[addr] = True
        fill_direct_mb(parser, addr)
        return
    if coded != 22:
        shape, pdirs = B_MBTYPE[coded]
        parts = list(zip(B_PARTS[shape], pdirs))
        refs = {}
        for lst in (0, 1):
            for i, ((bx, by, bw, bh), pd) in enumerate(parts):
                refs[lst, i] = (read_ref(bx, by, lst) if pd in _USES[lst]
                                else -1)
                _store_refs(pic, addr, bx, by, bw, bh, lst, refs[lst, i], pd)
        for lst in (0, 1):
            for i, (part, pd) in enumerate(parts):
                if pd in _USES[lst]:
                    read_part_mvd(parser, addr, *part, lst, refs[lst, i])
        return
    info = [B_SUBTYPE[t] for t in read_subs()]
    dp = None
    refs = [[0] * 4, [0] * 4]
    for lst in (0, 1):
        arr = pic.ref_idx if lst == 0 else pic.ref_idx_l1
        for q, (_shp, pd) in enumerate(info):
            if pd == PD_DIRECT:
                if lst == 0:
                    if dp is None and h.direct_spatial_mv_pred_flag:
                        dp = prepare_direct_params(parser.pctx, addr)
                    direct_quadrant(parser, addr, q, dp)
                continue
            refs[lst][q] = read_ref((q % 2) * 2, (q // 2) * 2, lst) \
                if pd in _USES[lst] else -1
            arr[addr, q] = refs[lst][q]
            if lst == 0:
                pic.pdir[addr, q] = pd
    for lst in (0, 1):
        for q, (shp, pd) in enumerate(info):
            if pd not in _USES[lst]:
                continue
            qx, qy = (q % 2) * 2, (q // 2) * 2
            sw, sh = shp
            for sy in range(0, 2, sh):
                for sx in range(0, 2, sw):
                    read_part_mvd(parser, addr, qx + sx, qy + sy, sw, sh,
                                   lst, refs[lst][q])


def ref_lists_b(frames, cur_poc: int):
    """(list0, list1) of a B slice before modification: the short-term
    pictures before cur_poc by descending POC, then those after by
    ascending POC (list 1 the other way round), then the long-term ones
    by LongTermFrameIdx; a list 1 equal to a list 0 of more than one
    entry has its first two swapped."""
    st = [f for f in frames if not f.is_long_term]
    lt = sorted((f for f in frames if f.is_long_term),
                key=lambda f: f.long_term_frame_idx)
    before = sorted((f for f in st if f.poc < cur_poc), key=lambda f: -f.poc)
    after = sorted((f for f in st if f.poc > cur_poc), key=lambda f: f.poc)
    l0 = before + after + lt
    l1 = after + before + lt
    if len(l0) > 1 and l0 == l1:
        l1 = [l1[1], l1[0]] + l1[2:]
    return l0, l1
