"""Shared prediction context: nC derivation (spec 9.2.1), intra-mode
prediction (8.3.1.1), median MV prediction (8.4.1.3), P_Skip MV (8.4.1.1).

Used by BOTH the decoder's slice parser and the encoder's mode
decision/serializer, guaranteeing the two sides derive identical
predictors from identical PictureData state (the property the reference
maintains by mirroring mv_prediction.c/mb_access.c in lencod and ldecod).
"""

from __future__ import annotations

import numpy as np

# raster <-> coding (z) order of 4x4 luma blocks within a MB
CODE2RASTER = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15],
                      dtype=np.int32)
RASTER2CODE = np.argsort(CODE2RASTER).astype(np.int32)


class PredCtx:
    """Neighbor-dependent prediction over a PictureData being filled in
    MB raster order (parse side) or encode order (encoder side)."""

    def __init__(self, pic):
        self.pic = pic
        self.mb_w = pic.mb_w

    # ---- availability ------------------------------------------------

    def left_addr(self, addr: int) -> int:
        return addr - 1 if addr % self.mb_w else -1

    def up_addr(self, addr: int) -> int:
        return addr - self.mb_w

    def avail(self, naddr: int, cur: int) -> bool:
        return (0 <= naddr < self.pic.n_mbs
                and self.pic.slice_id[naddr] == self.pic.slice_id[cur])

    # ---- nC (spec 9.2.1) ----------------------------------------------

    @staticmethod
    def _combine_nc(na, avail_a, nb, avail_b) -> int:
        if avail_a and avail_b:
            return (int(na) + int(nb) + 1) >> 1
        if avail_a:
            return int(na)
        if avail_b:
            return int(nb)
        return 0

    def nc_luma(self, addr: int, blk: int) -> int:
        pic = self.pic
        by, bx = divmod(blk, 4)
        if bx > 0:
            a_addr, a_blk, avail_a = addr, blk - 1, True
        else:
            a_addr, a_blk = self.left_addr(addr), blk + 3
            avail_a = self.avail(a_addr, addr)
        if by > 0:
            b_addr, b_blk, avail_b = addr, blk - 4, True
        else:
            b_addr, b_blk = self.up_addr(addr), blk + 12
            avail_b = self.avail(b_addr, addr)
        return self._combine_nc(pic.luma_nnz[a_addr, a_blk], avail_a,
                                pic.luma_nnz[b_addr, b_blk], avail_b)

    def nc_chroma(self, addr: int, comp: int, blk: int) -> int:
        pic = self.pic
        crows = getattr(pic, "n_crows", 2)
        by, bx = divmod(blk, 2)
        if bx > 0:
            a_addr, a_blk, avail_a = addr, blk - 1, True
        else:
            a_addr, a_blk = self.left_addr(addr), blk + 1
            avail_a = self.avail(a_addr, addr)
        if by > 0:
            b_addr, b_blk, avail_b = addr, blk - 2, True
        else:
            b_addr, b_blk = self.up_addr(addr), blk + 2 * (crows - 1)
            avail_b = self.avail(b_addr, addr)
        return self._combine_nc(pic.chroma_nnz[a_addr, comp, a_blk], avail_a,
                                pic.chroma_nnz[b_addr, comp, b_blk], avail_b)

    # ---- intra 4x4 mode prediction (spec 8.3.1.1) -----------------------

    def pred_intra4_mode(self, addr: int, blk: int) -> int:
        pic = self.pic
        by, bx = divmod(blk, 4)
        if bx > 0:
            ma = pic.i4_modes[addr, blk - 1]
            avail_a = True
            a_is_i4 = pic.mb_class[addr] == 1
            if not a_is_i4:
                ma = 2
        else:
            a_addr = self.left_addr(addr)
            avail_a = self.avail(a_addr, addr)
            ma = pic.i4_modes[a_addr, blk + 3] if avail_a else -1
            if avail_a and pic.mb_class[a_addr] != 1:
                ma = 2
        if by > 0:
            mb = pic.i4_modes[addr, blk - 4]
            avail_b = True
            if pic.mb_class[addr] != 1:
                mb = 2
        else:
            b_addr = self.up_addr(addr)
            avail_b = self.avail(b_addr, addr)
            mb = pic.i4_modes[b_addr, blk + 12] if avail_b else -1
            if avail_b and pic.mb_class[b_addr] != 1:
                mb = 2
        if not avail_a or not avail_b:
            return 2
        return int(min(ma, mb))

    # ---- MV prediction (spec 8.4.1.3) -----------------------------------

    def mv_neighbor(self, addr: int, bx: int, by: int, cur_blk: int = 0,
                    lst: int = 0):
        """(mv, ref) of the 4x4 block at block coords (bx, by) relative to
        MB addr's origin; None if unavailable; intra or no-motion-in-list
        -> (0, -1)."""
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        gx, gy = mbx * 4 + bx, mby * 4 + by
        if gx < 0 or gy < 0 or gx >= self.mb_w * 4:
            return None
        naddr = (gy // 4) * self.mb_w + (gx // 4)
        nblk = (gy % 4) * 4 + (gx % 4)
        if naddr == addr:
            if RASTER2CODE[nblk] >= RASTER2CODE[cur_blk]:
                return None
        else:
            if naddr > addr or not self.avail(naddr, addr):
                return None
        q = (nblk // 8) * 2 + ((nblk % 4) // 2)
        ref_arr = pic.ref_idx if lst == 0 else pic.ref_idx_l1
        mv_arr = pic.mv if lst == 0 else pic.mv_l1
        ref = int(ref_arr[naddr, q])
        if ref < 0:
            return (np.zeros(2, np.int32), -1)
        return (mv_arr[naddr, nblk].copy(), ref)

    def mv_pred(self, addr: int, bx: int, by: int, bw: int, bh: int,
                ref: int, lst: int = 0) -> np.ndarray:
        cur = by * 4 + bx
        a = self.mv_neighbor(addr, bx - 1, by, cur, lst)
        b = self.mv_neighbor(addr, bx, by - 1, cur, lst)
        c = self.mv_neighbor(addr, bx + bw, by - 1, cur, lst)
        if c is None:
            c = self.mv_neighbor(addr, bx - 1, by - 1, cur, lst)

        if bw == 4 and bh == 2:  # 16x8
            if by == 0 and b is not None and b[1] == ref:
                return b[0].copy()
            if by == 2 and a is not None and a[1] == ref:
                return a[0].copy()
        elif bw == 2 and bh == 4:  # 8x16
            if bx == 0 and a is not None and a[1] == ref:
                return a[0].copy()
            if bx == 2 and c is not None and c[1] == ref:
                return c[0].copy()

        mva = a[0] if a is not None else np.zeros(2, np.int32)
        mvb = b[0] if b is not None else np.zeros(2, np.int32)
        mvc = c[0] if c is not None else np.zeros(2, np.int32)
        refa = a[1] if a is not None else -2
        refb = b[1] if b is not None else -2
        refc = c[1] if c is not None else -2

        if a is not None and b is None and c is None:
            return mva.copy()
        match = [r == ref for r in (refa, refb, refc)]
        if sum(match) == 1:
            return (mva, mvb, mvc)[match.index(True)].copy()
        # the component-wise median of three (np.median's, without its
        # cost on three values)
        return np.array([sorted((int(mva[k]), int(mvb[k]), int(mvc[k])))[1]
                         for k in (0, 1)], np.int32)

    def skip_mv(self, addr: int) -> np.ndarray:
        """P_Skip motion vector (spec 8.4.1.1)."""
        a = self.mv_neighbor(addr, -1, 0)
        b = self.mv_neighbor(addr, 0, -1)
        if (a is None or b is None or
                (a[1] == 0 and a[0][0] == 0 and a[0][1] == 0) or
                (b[1] == 0 and b[0][0] == 0 and b[0][1] == 0)):
            return np.zeros(2, np.int32)
        return self.mv_pred(addr, 0, 0, 4, 4, 0)
