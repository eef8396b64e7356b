"""Decoded picture buffer of short-term reference frames (spec 8.2.4 /
8.2.5.3): sliding window, IDR flush, P-slice list0 initialization and
ref_pic_list_modification; twin of jm_tpu/decoder/dpb.py without MMCO
and long-term references (ldecod/src/mbuffer.c store_picture_in_dpb,
init_lists_p_slice, sliding_window_memory_management).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Frame:
    """A decoded frame as a reference: its device reference state
    (ops/enc.prep_ref: quarter-pel planes (4, H+2P, W+2P), padded U, V)."""
    poc: int
    frame_num: int
    state: tuple
    is_ref: bool = True
    uid: int = -1            # unique decode-order id (deblock bS compare)


class DPB:
    def __init__(self, sps):
        self.sps = sps
        self.frames: list[Frame] = []      # reference frames, decode order
        self.max_refs = max(1, sps.max_num_ref_frames)
        self._uid = 0

    def idr_flush(self) -> None:
        self.frames.clear()

    def store(self, frame: Frame, idr=False) -> None:
        frame.uid = self._uid
        self._uid += 1
        if idr:
            self.idr_flush()
        if not frame.is_ref:
            return
        # sliding window (spec 8.2.5.3): drop the oldest short-term frame
        while len(self.frames) >= self.max_refs and self.frames:
            self.frames.remove(min(self.frames, key=lambda f: f.uid))
        self.frames.append(frame)

    def ref_list_p(self, cur_frame_num: int) -> list[Frame]:
        """List0 for P slices: short-term frames by PicNum (FrameNumWrap)
        descending."""
        max_fn = self.sps.max_frame_num

        def pic_num(f: Frame) -> int:
            return (f.frame_num if f.frame_num <= cur_frame_num
                    else f.frame_num - max_fn)

        return sorted(self.frames, key=pic_num, reverse=True)

    def reorder_list(self, lst: list[Frame], mods, cur_frame_num: int,
                     num_active: int) -> list[Frame]:
        """Apply ref_pic_list_modification commands (spec 8.2.4.3.1)."""
        if not mods:
            return lst[:num_active]
        max_fn = self.sps.max_frame_num
        lst = list(lst)
        pred = cur_frame_num
        for idx, m in enumerate(mods):
            diff = m.value + 1
            pred = (pred - diff) % max_fn if m.op == 0 else (pred + diff) % max_fn
            wanted = pred if pred <= cur_frame_num else pred - max_fn
            target = None
            for f in lst:
                fpn = (f.frame_num if f.frame_num <= cur_frame_num
                       else f.frame_num - max_fn)
                if fpn == wanted:
                    target = f
                    break
            if target is None:
                raise ValueError("ref reorder: pic_num not found")
            lst.remove(target)
            lst.insert(idx, target)
        return lst[:num_active]
