"""The encoder's weighted prediction estimates (twin of
jm_tpu/encoder/wp_est.py; lencod weighted_prediction.c
EstimateWPPSliceAlg0, wp_lms.c, wp_mciter.c): per reference picture a
table {"luma": (w, o), "chroma": ((w, o), (w, o))}, the layout of the
decoder's pred_weight_table (SliceHeader.wp_l0 / wp_l1), at denominator
5 for luma and chroma. Implicit B weights come from POC distances; the
encoder takes them, and every applied table, from the decoder's
WPParams (decoder/wp.py), so its prediction is the decoder's.

The estimators read each reference's deblocked planes on the host
(``f.Y`` / ``f.U`` / ``f.V``: the port's Picture downloads them once) and
keep jm_tpu's float64 operations in its order.
"""

from __future__ import annotations

import numpy as np

from ..common.types import SliceType
from ..decoder.wp import WPParams

LUMA_DENOM = 5
CHROMA_DENOM = 5


def _dc_weight(dco: float, plane) -> int:
    """round(32 dc_org / dc_ref), the default weight for a zero
    reference, clipped to [-128, 127]."""
    default = 1 << LUMA_DENOM
    dcr = float(np.asarray(plane, np.float64).sum())
    w = default if dcr == 0.0 else int(default * dco / dcr + 0.5)
    return max(-128, min(127, w))


def _dc(orig) -> float:
    return float(np.asarray(orig, np.float64).sum())


def estimate_explicit(origY, origU, origV, refs) -> list[dict]:
    """The DC-ratio estimate (WPMethod 0): per component weight
    round(32 dc_org / dc_ref), offset 0."""
    dco = (_dc(origY), _dc(origU), _dc(origV))
    out = []
    for f in refs:
        ws = [_dc_weight(dco[c], p) for c, p in enumerate((f.Y, f.U, f.V))]
        out.append({"luma": (ws[0], 0),
                    "chroma": ((ws[1], 0), (ws[2], 0))})
    return out


def estimate_lms(origY, origU, origV, refs,
                 select_offset: int = 0) -> list[dict]:
    """The LMS estimate (WPMethod 1): luma weight round(32 sum|org -
    mean_org| / sum|ref - mean_ref|) with offset round(mean_org - w
    mean_ref / 32); select_offset 1 the offset-only variant (weight 32,
    offset the rounded mean difference), which wp_mcprec trials. Chroma
    keeps the DC-ratio weights."""
    default = 1 << LUMA_DENOM
    oY = np.asarray(origY, np.float64)
    mean_org = float(oY.mean())
    numer = float(np.abs(oY - mean_org).sum())
    dco = (float(oY.sum()), _dc(origU), _dc(origV))
    out = []
    for f in refs:
        rY = np.asarray(f.Y, np.float64)
        mean_ref = float(rY.mean())
        if select_offset:
            w = default
            o = int((dco[0] - rY.sum()) / rY.size + 0.5)
        else:
            den = float(np.abs(rY - mean_ref).sum())
            w = default if den == 0.0 else int(default * numer / den + 0.5)
            w = max(-128, min(127, w))
            o = int(mean_org - w * mean_ref / default + 0.5)
        o = max(-128, min(127, o))
        out.append({"luma": (w, o),
                    "chroma": ((_dc_weight(dco[1], f.U), 0),
                               (_dc_weight(dco[2], f.V), 0))})
    return out


def estimate_mc_iter(origY, origU, origV, refs, iters: int = 2,
                     rng: int = 4) -> list[dict]:
    """The iterative motion-compensated estimate (WPIterMC): the luma DC
    ratio against the reference aligned by a 16x16 integer search of
    +-rng around each MB (over the weighted reference), iters rounds from
    the co-located DC ratio; chroma keeps the DC-ratio weights."""
    default = 1 << LUMA_DENOM
    org = np.asarray(origY, np.int32)
    H, W = org.shape
    mbh, mbw = H // 16, W // 16
    Hc, Wc = mbh * 16, mbw * 16
    orgc = org[:Hc, :Wc]
    dco = (float(org.sum()), _dc(origU), _dc(origV))
    out = []
    for f in refs:
        ref = np.asarray(f.Y, np.int32)
        pad = np.pad(ref[:Hc, :Wc], rng, mode="edge")
        dcr0 = float(ref.sum())
        w = default if dcr0 == 0.0 else \
            max(-128, min(127, int(default * dco[0] / dcr0 + 0.5)))
        o = 0
        for _ in range(max(1, iters)):
            wref = np.clip((pad * w + (1 << (LUMA_DENOM - 1)))
                           >> LUMA_DENOM, 0, 1 << 14) + o
            best = np.full((mbh, mbw), 1 << 30, np.int64)
            bdy = np.zeros((mbh, mbw), np.int32)
            bdx = np.zeros((mbh, mbw), np.int32)
            for dy in range(-rng, rng + 1):
                for dx in range(-rng, rng + 1):
                    sh = wref[rng + dy:rng + dy + Hc, rng + dx:rng + dx + Wc]
                    sad = np.abs(orgc - sh).reshape(mbh, 16, mbw, 16) \
                        .sum(axis=(1, 3))
                    m = sad < best
                    best = np.where(m, sad, best)
                    bdy = np.where(m, dy, bdy)
                    bdx = np.where(m, dx, bdx)
            # the unweighted reference at the chosen displacements
            mc = np.empty_like(orgc)
            for by in range(mbh):
                for bx in range(mbw):
                    dy, dx = int(bdy[by, bx]), int(bdx[by, bx])
                    mc[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16] = \
                        pad[rng + by * 16 + dy:rng + by * 16 + dy + 16,
                            rng + bx * 16 + dx:rng + bx * 16 + dx + 16]
            dcr = float(mc.sum())
            w = default if dcr == 0.0 else \
                int(default * float(orgc.sum()) / dcr + 0.5)
            w = max(-128, min(127, w))
            o = 0
        out.append({"luma": (w, o),
                    "chroma": ((_dc_weight(dco[1], f.U), 0),
                               (_dc_weight(dco[2], f.V), 0))})
    return out


def is_nontrivial(tables: list[dict]) -> bool:
    """True when a weight or offset departs from the default."""
    default = 1 << LUMA_DENOM
    return any(e["luma"] != (default, 0)
               or any(tuple(c) != (default, 0) for c in e["chroma"])
               for e in tables)


class _WPHeader:
    """The slice-header fields WPParams reads."""

    def __init__(self, slice_type, wp_l0, wp_l1):
        self.slice_type = slice_type
        self.luma_log2_weight_denom = LUMA_DENOM
        self.chroma_log2_weight_denom = CHROMA_DENOM
        self.wp_l0 = wp_l0 or []
        self.wp_l1 = wp_l1 or []


def build_wp_params(slice_type: SliceType, pps, lst0, lst1, cur_poc: int,
                    wp_l0=None, wp_l1=None):
    """The decoder's WPParams of a slice the encoder writes with these
    tables, or None when the PPS gives the slice no weighted
    prediction."""
    wp = WPParams(_WPHeader(slice_type, wp_l0, wp_l1), pps, lst0, lst1,
                  cur_poc)
    return wp if wp.mode else None
