"""Weighted prediction tables of a slice (spec 8.4.2.3; twin of
jm_tpu/decoder/wp.py, ldecod image.c fill_wp_params and mc_prediction.c
weighted_mc_prediction / weighted_bi_prediction), samples of 8 to 14
bits: the explicit offsets are scaled by 1 << (bitDepth - 8) and the
predictions clipped at (1 << bitDepth) - 1 (spec 8.4.2.3.2, 8.4.3).

``WPParams`` holds a slice's explicit tables (mode 1: a P slice of a PPS
with weighted_pred_flag, a B slice with weighted_bipred_idc 1) or its
implicit ones (mode 2: weighted_bipred_idc 2, weights from POC distances);
``uni`` / ``bi`` apply them to numpy blocks, as the encoder's host coders
do. The decoder applies the same tables on the device (ops/dec.py).
"""

from __future__ import annotations

import numpy as np

from ..common.types import SliceType


def _c_div(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


class WPParams:
    """Per-slice weighted prediction: mode 0 off, 1 explicit, 2 implicit.

    weight[l][ref][comp], offset[l][ref][comp] (comp 0 Y, 1 Cb, 2 Cr) for
    single-list prediction; wbp_w0 / wbp_w1 [ref0][ref1][comp] for
    bi-prediction; luma_denom / chroma_denom the logWD of each; the
    offsets already scaled to bd = (luma, chroma) bits, ``cmax`` the clip
    of each component."""

    def __init__(self, hdr, pps, lst0, lst1, cur_poc: int, bd=(8, 8)):
        self.mode = 0
        self.cmax = ((1 << bd[0]) - 1, (1 << bd[1]) - 1, (1 << bd[1]) - 1)
        oscale = (1 << (bd[0] - 8), 1 << (bd[1] - 8))
        st = hdr.slice_type
        if st in (SliceType.P, SliceType.SP) and pps.weighted_pred_flag:
            self.mode = 1
        elif st == SliceType.B and pps.weighted_bipred_idc in (1, 2):
            self.mode = pps.weighted_bipred_idc
        if self.mode == 0:
            return
        n0, n1 = max(len(lst0), 1), max(len(lst1), 1)
        if self.mode == 1:
            self.luma_denom = hdr.luma_log2_weight_denom
            self.chroma_denom = hdr.chroma_log2_weight_denom
            m = max(n0, n1)
            self.weight = np.zeros((2, m, 3), np.int32)
            self.offset = np.zeros((2, m, 3), np.int32)
            for lst, table in ((0, hdr.wp_l0), (1, hdr.wp_l1)):
                for r in range(m):
                    if r < len(table):
                        e = table[r]
                        w, o = e["luma"]
                        self.weight[lst, r, 0] = w
                        self.offset[lst, r, 0] = o * oscale[0]
                        for j in range(2):
                            w, o = e["chroma"][j]
                            self.weight[lst, r, 1 + j] = w
                            self.offset[lst, r, 1 + j] = o * oscale[1]
                    else:
                        # a missing entry: the default weight, offset 0
                        self.weight[lst, r, 0] = 1 << self.luma_denom
                        self.weight[lst, r, 1:] = 1 << self.chroma_denom
            # explicit bi weights are each list's own
            self.wbp_w0 = np.broadcast_to(self.weight[0][:, None, :],
                                          (m, m, 3))
            self.wbp_w1 = np.broadcast_to(self.weight[1][None, :, :],
                                          (m, m, 3))
            return
        # implicit (spec 8.4.2.3.2): single-list blocks keep the default
        # prediction; bi weights from the POC distances, 32 / 32 for
        # long-term references, td == 0, or a weight outside [-64, 128]
        self.luma_denom = self.chroma_denom = 5
        m = max(n0, n1)
        self.weight = np.full((2, m, 3), 32, np.int32)
        self.offset = np.zeros((2, m, 3), np.int32)
        w0 = np.full((n0, n1, 3), 32, np.int32)
        w1 = np.full((n0, n1, 3), 32, np.int32)
        for i, f0 in enumerate(lst0):
            for j, f1 in enumerate(lst1):
                td = max(-128, min(127, f1.poc - f0.poc))
                if td == 0 or f0.is_long_term or f1.is_long_term:
                    continue
                tb = max(-128, min(127, cur_poc - f0.poc))
                tx = _c_div(16384 + abs(_c_div(td, 2)), td)
                dsf = max(-1024, min(1023, (tx * tb + 32) >> 6))
                wv1 = dsf >> 2
                if -64 <= wv1 <= 128:
                    w0[i, j, :] = 64 - wv1
                    w1[i, j, :] = wv1
        self.wbp_w0, self.wbp_w1 = w0, w1

    def uni(self, pred, lst: int, ref: int, comp: int) -> np.ndarray:
        """Weighted single-list prediction of a block, clipped to
        0..cmax."""
        w = int(self.weight[lst, ref, comp])
        o = int(self.offset[lst, ref, comp])
        d = self.luma_denom if comp == 0 else self.chroma_denom
        x = pred.astype(np.int64) * w
        if d > 0:
            x = (x + (1 << (d - 1))) >> d
        return np.clip(x + o, 0, self.cmax[comp])

    def bi(self, p0, p1, ref0: int, ref1: int, comp: int) -> np.ndarray:
        """Weighted bi-prediction of a block, clipped to 0..cmax."""
        w0 = int(self.wbp_w0[ref0, ref1, comp])
        w1 = int(self.wbp_w1[ref0, ref1, comp])
        o = (int(self.offset[0, ref0, comp])
             + int(self.offset[1, ref1, comp]) + 1) >> 1
        d = (self.luma_denom if comp == 0 else self.chroma_denom) + 1
        x = (p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
             + (1 << (d - 1))) >> d
        return np.clip(x + o, 0, self.cmax[comp])


def block_tables(wps, pic) -> tuple:
    """The per-8x8 weights and offsets of a picture's MBs for the device
    inter recon (ops/dec._weigh_planes): wps the WPParams of each slice
    (by slice id); each MB takes its own slice's tables, indexed by its
    per-8x8 ref_idx / ref_idx_l1 (the list index inside that slice), and
    implicit weights by the (ref_idx_l0, ref_idx_l1) pair of its
    bi-predicted 8x8s (B_Skip / B_Direct included, whose indices the
    direct derivation set). Single-list 8x8s of an implicit slice, and
    the MBs of a slice without weighted prediction, get the identity
    (weight 32 at logWD 5, weight 1 at logWD 0). Returns (w0, o0, w1,
    o1) (N, 4, 3) and logwd (N, 2) int32."""
    n = pic.n_mbs
    w0 = np.ones((n, 4, 3), np.int32)
    w1 = np.ones((n, 4, 3), np.int32)
    o0 = np.zeros((n, 4, 3), np.int32)
    o1 = np.zeros((n, 4, 3), np.int32)
    logwd = np.zeros((n, 2), np.int32)
    for sid, wp in enumerate(wps):
        if wp is None or not wp.mode:          # None: a dropped slice
            continue
        m = np.flatnonzero(pic.slice_id == sid)
        logwd[m] = (wp.luma_denom, wp.chroma_denom)
        if wp.mode == 1:
            top = wp.weight.shape[1] - 1
            r0 = np.clip(pic.ref_idx[m], 0, top)
            r1 = np.clip(pic.ref_idx_l1[m], 0, top)
            w0[m], o0[m] = wp.weight[0][r0], wp.offset[0][r0]
            w1[m], o1[m] = wp.weight[1][r1], wp.offset[1][r1]
        else:
            r0 = np.clip(pic.ref_idx[m], 0, wp.wbp_w0.shape[0] - 1)
            r1 = np.clip(pic.ref_idx_l1[m], 0, wp.wbp_w0.shape[1] - 1)
            bi = (pic.pdir[m] == 2)[..., None]
            w0[m] = np.where(bi, wp.wbp_w0[r0, r1], 32)
            w1[m] = np.where(bi, wp.wbp_w1[r0, r1], 32)
    return w0, o0, w1, o1, logwd
