"""Decoded picture buffer of reference frames (spec 8.2.4 / 8.2.5): the
sliding window, IDR flush, adaptive marking (MMCO ops 1-6) with
long-term references, P-slice list0 initialization (short-term by PicNum
descending, then long-term by LongTermFrameIdx) and
ref_pic_list_modification with short- and long-term commands; twin of
jm_tpu/decoder/dpb.py for frame pictures (ldecod/src/mbuffer.c
store_picture_in_dpb, adaptive_memory_management, init_lists_p_slice,
sliding_window_memory_management). B slices take their initial lists
from decoder/b_slice.ref_lists_b and the same modification. A
non-reference picture takes a uid and is never stored. There is no
output bumping, as in jm_tpu: the decoder returns pictures in decode
order, and callers sort them by POC.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Frame:
    """A decoded frame as a reference: its device reference state
    (ops/enc.prep_ref: quarter-pel planes (4, H+2P, W+2P), padded U, V)
    and, for the direct prediction of the B pictures that take it as
    list1[0], its motion (mv, ref_idx, mv_l1, ref_idx_l1, ref_pic_id,
    ref_pic_id_l1: the PictureData arrays, host numpy)."""
    poc: int
    frame_num: int
    state: tuple
    is_ref: bool = True
    is_long_term: bool = False
    long_term_frame_idx: int = -1
    uid: int = -1            # unique decode-order id (deblock bS compare)
    motion: tuple | None = None
    parity: int | None = None    # a reference field's (0 top, 1 bottom)
    # a concealed frame's (Y, U, V) device samples: above 8 bits its
    # state is not made of them (decoder/conceal.concealed_state)
    planes: tuple | None = None


class DPB:
    def __init__(self, sps, uid0: int = 0):
        """uid0: the first uid (the view-1 DPB of an MVC stream counts
        apart from view 0's, whose pictures share its lists)."""
        self.sps = sps
        self.frames: list[Frame] = []      # reference frames, decode order
        self.max_refs = max(1, sps.max_num_ref_frames)
        self._uid = uid0

    def idr_flush(self) -> None:
        self.frames.clear()

    def store(self, frame: Frame, mmco_ops=None, idr=False,
              long_term_flag=0) -> None:
        """Mark and store a decoded picture: an IDR flushes the buffer
        (and is long-term with long_term_flag), MMCO commands replace the
        sliding window (spec 8.2.5.4), non-reference pictures only take
        a uid."""
        frame.uid = self._uid
        self._uid += 1
        if idr:
            self.idr_flush()
            if long_term_flag:
                frame.is_long_term = True
                frame.long_term_frame_idx = 0
        if not frame.is_ref:
            return
        if mmco_ops:
            self._apply_mmco(frame, mmco_ops)
        else:
            # sliding window (spec 8.2.5.3): long-term frames stay
            short = [f for f in self.frames if not f.is_long_term]
            num_long = len(self.frames) - len(short)
            while len(short) + num_long >= self.max_refs and short:
                oldest = min(short, key=lambda f: f.uid)
                self.frames.remove(oldest)
                short.remove(oldest)
        self.frames.append(frame)

    def _apply_mmco(self, frame: Frame, ops) -> None:
        max_fn = self.sps.max_frame_num
        for op in ops:
            if op.op == 1:   # unmark short-term
                pic_num = frame.frame_num - (op.value1 + 1)
                target = pic_num if pic_num >= 0 else pic_num + max_fn
                for f in list(self.frames):
                    if not f.is_long_term and f.frame_num == target:
                        self.frames.remove(f)
            elif op.op == 2:  # unmark long-term
                for f in list(self.frames):
                    if f.is_long_term and f.long_term_frame_idx == op.value1:
                        self.frames.remove(f)
            elif op.op == 3:  # short-term -> long-term
                pic_num = frame.frame_num - (op.value1 + 1)
                target = pic_num if pic_num >= 0 else pic_num + max_fn
                self._unmark_lt_idx(op.value2)
                for f in self.frames:
                    if not f.is_long_term and f.frame_num == target:
                        f.is_long_term = True
                        f.long_term_frame_idx = op.value2
            elif op.op == 4:  # max long-term index
                for f in list(self.frames):
                    if f.is_long_term and \
                            f.long_term_frame_idx >= op.value1 - 1 >= -1:
                        if f.long_term_frame_idx > op.value1 - 1:
                            self.frames.remove(f)
            elif op.op == 5:  # unmark all
                self.frames.clear()
            elif op.op == 6:  # current -> long-term
                self._unmark_lt_idx(op.value1)
                frame.is_long_term = True
                frame.long_term_frame_idx = op.value1

    def _unmark_lt_idx(self, idx: int) -> None:
        """Spec 8.2.5.4.3 / .6: a frame already holding this long-term
        index is marked unused for reference."""
        for f in list(self.frames):
            if f.is_long_term and f.long_term_frame_idx == idx:
                self.frames.remove(f)

    # ---- reference list construction (spec 8.2.4.2) -----------------------

    def _pic_num(self, f: Frame, cur_frame_num: int) -> int:
        """PicNum (FrameNumWrap) of a short-term frame."""
        return (f.frame_num if f.frame_num <= cur_frame_num
                else f.frame_num - self.sps.max_frame_num)

    def ref_list_p(self, cur_frame_num: int) -> list[Frame]:
        """List0 for P slices: short-term frames by PicNum descending,
        then long-term frames by LongTermPicNum ascending."""
        short = sorted((f for f in self.frames if not f.is_long_term),
                       key=lambda f: self._pic_num(f, cur_frame_num),
                       reverse=True)
        long = sorted((f for f in self.frames if f.is_long_term),
                      key=lambda f: f.long_term_frame_idx)
        return short + long

    def reorder_list(self, lst: list[Frame], mods, cur_frame_num: int,
                     num_active: int, inter_view=None) -> list[Frame]:
        """Apply ref_pic_list_modification commands (spec 8.2.4.3.1 short-
        term, 8.2.4.3.2 long-term, H.8.2.2.3 inter-view idc 4 / 5). With
        one dependent view the only inter-view candidate is
        ``inter_view``, the current access unit's view-0 picture that the
        caller appended to ``lst``."""
        if not mods:
            return lst[:num_active]
        max_fn = self.sps.max_frame_num
        lst = list(lst)
        pred = cur_frame_num
        for idx, m in enumerate(mods):
            if m.op in (0, 1):
                diff = m.value + 1
                pred = (pred - diff) % max_fn if m.op == 0 \
                    else (pred + diff) % max_fn
                wanted = pred if pred <= cur_frame_num else pred - max_fn
                target = next((f for f in lst if not f.is_long_term and
                               self._pic_num(f, cur_frame_num) == wanted),
                              None)
            elif m.op in (4, 5):
                if inter_view is None:
                    raise ValueError("inter-view reorder without MVC ref")
                target = inter_view
            else:
                target = next((f for f in lst if f.is_long_term and
                               f.long_term_frame_idx == m.value), None)
            if target is None:
                raise ValueError("ref reorder: picture not found")
            lst.remove(target)
            lst.insert(idx, target)
        return lst[:num_active]


# ---- reference fields of PAFF streams (spec 8.2.4.2.5, 8.2.5.3) -----------

def field_ref_list_p(fields, parity: int, frame_num_wrap) -> list:
    """Initial list0 of a P field (spec 8.2.4.2.2 + 8.2.4.2.5; jm_tpu
    decoder.py:779-804, encoder.py:1051-1076): the short-term reference
    fields (newest first) in frame units by FrameNumWrap
    (frame_num_wrap(field)) descending, taken alternately by parity
    starting with the current one, each parity's rest appended when the
    other runs out."""
    units: dict = {}
    for f in fields:
        if not f.is_long_term:
            units.setdefault(frame_num_wrap(f), []).append(f)
    order = [f for k in sorted(units, reverse=True) for f in units[k]]
    same = [f for f in order if f.parity == parity]
    opp = [f for f in order if f.parity != parity]
    out = []
    for i in range(max(len(same), len(opp))):
        out += same[i:i + 1] + opp[i:i + 1]
    return out


def field_window(fields, max_frames: int) -> list:
    """The reference fields (newest first) the sliding window keeps: at
    most max(1, max_frames) frame units, a complementary pair (same
    frame_num, both parities, one after the other) or an unpaired field
    being one unit, the oldest units dropped (spec 8.2.5.3; jm_tpu
    decoder.py:817-830, encoder.py:1146-1165)."""
    units = []
    for f in fields:
        if units and len(units[-1]) == 1 \
                and f.frame_num == units[-1][0].frame_num \
                and f.parity != units[-1][0].parity:
            units[-1].append(f)
        else:
            units.append([f])
    return [f for u in units[:max(1, max_frames)] for f in u]
