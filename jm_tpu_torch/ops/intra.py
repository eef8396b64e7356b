"""Whole-picture I-frame encode on tensors (twin of
jm_tpu/ops/intra_jax.py ``i_frame_step``).

Intra prediction reads the reconstruction of the left, up, up-left and
up-right MBs, so MBs run in anti-diagonal waves d = mbx + 2 mby: every MB
of a wave depends only on earlier waves (the restructured lencod
slice.c:486 MB loop). Per wave, for all its MBs at once: the 16 Intra4x4
blocks in coding order (9 modes each, most-probable-mode penalty), the
Intra16x16 candidate (4 modes), the md_low I16-vs-I4 choice, chroma (4
modes), exact residual coding and reconstruction. Only the MBs that
exist in a wave are batched, so no write is ever out of range; argmin
ties keep the first mode, as in JAX.

A wave is a few hundred small tensor ops, so on the card the host's
launches bound it. There the tensors that the waves touch are kept per
picture size and QP (_WaveState) and each wave is captured as a CUDA
graph when it first runs; later pictures of that size and QP replay the
graphs: the same kernels on the same tensors, one launch per wave.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quant as Q
from . import transform as T
from .consts import on
from .enc import chroma_residual, from_scan, to_scan

I32 = torch.int32

CODE2RASTER = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]
RASTER2CODE = [CODE2RASTER.index(i) for i in range(16)]


# I4 predictor tap tables: every mode except DC is, per output pixel,
# (w0 r[i0] + w1 r[i1] + w2 r[i2] + rnd) >> sh over the 13-sample
# reference vector rr = [l3, l2, l1, l0, m, t0..t7]
def _li(k):
    return 3 - k


def _ti(k):
    return 5 + k


_MI = 4


def _build_i4_taps():
    """(8, 16, 3) indices and weights, (8, 16) rounding and shift, for
    VERT HOR DDL DDR VR HD VL HU (spec 8.3.1.2)."""
    idx = np.zeros((8, 16, 3), np.int64)
    wgt = np.zeros((8, 16, 3), np.int32)
    rnd = np.zeros((8, 16), np.int32)
    sh = np.zeros((8, 16), np.int32)

    def put(mi, y, x, taps, r, s):
        for k, (i, w) in enumerate(taps):
            idx[mi, y * 4 + x, k] = i
            wgt[mi, y * 4 + x, k] = w
        rnd[mi, y * 4 + x] = r
        sh[mi, y * 4 + x] = s

    for y in range(4):
        for x in range(4):
            put(0, y, x, [(_ti(x), 1)], 0, 0)                     # VERT
            put(1, y, x, [(_li(y), 1)], 0, 0)                     # HOR
            i = x + y                                             # DDL
            put(2, y, x, [(_ti(i), 1), (_ti(min(i + 1, 7)), 2),
                          (_ti(min(i + 2, 7)), 1)], 2, 2)
            j = 4 + x - y                                         # DDR
            put(3, y, x, [(j - 1, 1), (j, 2), (j + 1, 1)], 2, 2)
            z = 2 * x - y                                         # VR
            k = x - (y >> 1)
            if z >= 0 and z % 2 == 0:
                put(4, y, x, [(4 + k, 1), (4 + k + 1, 1)], 1, 1)
            elif z >= 0:
                put(4, y, x, [(4 + k - 1, 1), (4 + k, 2), (4 + k + 1, 1)],
                    2, 2)
            elif z == -1:
                put(4, y, x, [(_li(0), 1), (_MI, 2), (_ti(0), 1)], 2, 2)
            else:
                put(4, y, x, [(4 - y, 1), (4 - (y - 1), 2),
                              (4 - (y - 2), 1)], 2, 2)
            z = 2 * y - x                                         # HD
            k = y - (x >> 1)
            if z >= 0 and z % 2 == 0:
                put(5, y, x, [(4 - k, 1), (4 - (k + 1), 1)], 1, 1)
            elif z >= 0:
                put(5, y, x, [(4 - (k - 1), 1), (4 - k, 2),
                              (4 - (k + 1), 1)], 2, 2)
            elif z == -1:
                put(5, y, x, [(_ti(0), 1), (_MI, 2), (_li(0), 1)], 2, 2)
            else:
                put(5, y, x, [(4 + x, 1), (4 + x - 1, 2), (4 + x - 2, 1)],
                    2, 2)
            k = x + (y >> 1)                                      # VL
            if y % 2 == 0:
                put(6, y, x, [(_ti(k), 1), (_ti(k + 1), 1)], 1, 1)
            else:
                put(6, y, x, [(_ti(k), 1), (_ti(k + 1), 2), (_ti(k + 2), 1)],
                    2, 2)
            z = x + 2 * y                                         # HU
            if z > 5:
                put(7, y, x, [(_li(3), 1)], 0, 0)
            elif z == 5:
                put(7, y, x, [(_li(2), 1), (_li(3), 3)], 2, 2)
            elif z % 2 == 0:
                kk = y + (x >> 1)
                put(7, y, x, [(_li(kk), 1), (_li(kk + 1), 1)], 1, 1)
            else:
                kk = y + (x >> 1)
                put(7, y, x, [(_li(kk), 1), (_li(kk + 1), 2),
                              (_li(kk + 2), 1)], 2, 2)
    return idx, wgt, rnd, sh


I4_IDX, I4_WGT, I4_RND, I4_SH = _build_i4_taps()

# I4 modes allowed by the neighbours (host candidate set)
_M_TOP = np.array([1, 0, 0, 1, 0, 0, 0, 1, 0], bool)      # VERT DDL VL
_M_LEFT = np.array([0, 1, 0, 0, 0, 0, 0, 0, 1], bool)     # HOR HU
_M_ALL3 = np.array([0, 0, 0, 0, 1, 1, 1, 0, 0], bool)     # DDR VR HD
_M_DC = np.array([0, 0, 1, 0, 0, 0, 0, 0, 0], bool)
_QUAD_BITS = np.array([1, 2, 4, 8], np.int32)
_QB = np.array([[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13],
                [10, 11, 14, 15]], np.int64)


def i4_predict_all(rr, avail_t, avail_l):
    """rr (B, 13) int32 -> (B, 9, 16) predictions in mode-id order
    (VERT HOR DC DDL DDR VR HD VL HU); unavailable modes are garbage and
    masked by the caller."""
    dev = rr.device
    g = rr[:, on(I4_IDX, dev).reshape(-1)].reshape(-1, 8, 16, 3)
    lin = ((g * on(I4_WGT, dev)).sum(-1) + on(I4_RND, dev)) >> on(I4_SH, dev)
    st = rr[:, 5:9].sum(1)
    sl = rr[:, 0:4].sum(1)
    dc = torch.where(avail_t & avail_l, (st + sl + 4) >> 3,
                     torch.where(avail_t, (st + 2) >> 2,
                                 torch.where(avail_l, (sl + 2) >> 2, 128)))
    dc = dc[:, None].expand(rr.shape[0], 16)
    return torch.stack([lin[:, 0], lin[:, 1], dc, lin[:, 2], lin[:, 3],
                        lin[:, 4], lin[:, 5], lin[:, 6], lin[:, 7]], dim=1)


def _code_i4_block(o, pred, qp):
    """(B, 4, 4) orig / pred -> (scan (B, 16), nnz (B,), recon (B, 4, 4))."""
    lev = Q.quant_4x4(T.forward4x4(o - pred), qp, True)
    scan = to_scan(lev)
    rec = torch.clamp(pred + T.inverse4x4_round(Q.dequant_4x4(lev, qp)),
                      0, 255)
    return scan, (scan != 0).sum(-1).to(I32), rec


def _wave_lanes(mb_w: int, mb_h: int):
    """Per wave d, the MBs (ys, xs) with xs = d - 2 ys inside the frame."""
    wmax = min(mb_h, (mb_w + 1 + 1) // 2)
    lanes = []
    for d in range(mb_w - 1 + 2 * (mb_h - 1) + 1):
        y0 = max(0, (d - (mb_w - 1) + 1) // 2)
        ys = [y for y in range(y0, y0 + wmax)
              if y < mb_h and 0 <= d - 2 * y < mb_w]
        lanes.append((ys, [d - 2 * y for y in ys]))
    return lanes


class _WaveState:
    """The tensors that i_frame_step's waves read and write: the source
    planes (int32), the padded recon planes, the decided SoA fields, the
    wave lanes and the constants, made once for a picture size and QP, so
    that the waves of later pictures (CUDA graphs, _graphed) find them at
    the same addresses."""

    def __init__(self, dev, qp: int, qpc: int, lam: int, lam4: int,
                 mb_w: int, mb_h: int):
        n = mb_w * mb_h
        h, w = mb_h * 16, mb_w * 16
        self.dev, self.mb_w, self.mb_h = dev, mb_w, mb_h
        self.qpc, self.lam, self.lam4 = qpc, lam, lam4
        self.o32 = torch.empty((h, w), dtype=I32, device=dev)
        self.oU = torch.empty((h // 2, w // 2), dtype=I32, device=dev)
        self.oV = torch.empty((h // 2, w // 2), dtype=I32, device=dev)
        # (1,), not 0-d: a 0-d index into a card's table reads it back
        # to the host (a sync, which no CUDA graph may hold)
        self.qpv = torch.full((1,), qp, dtype=I32, device=dev)

        def zeros(*shape):
            return torch.zeros(shape, dtype=I32, device=dev)

        self.recY = zeros(1 + h, 1 + w + 16)
        self.recU = zeros(1 + h // 2, 1 + w // 2)
        self.recV = zeros(1 + h // 2, 1 + w // 2)
        self.out = {
            "cls": zeros(n), "i4m": torch.full((n, 16), -1, dtype=I32,
                                               device=dev),
            "i16m": torch.full((n,), -1, dtype=I32, device=dev),
            "cmode": zeros(n), "cbp": zeros(n), "lcoef": zeros(n, 16, 16),
            "ldc": zeros(n, 16), "lnnz": zeros(n, 16), "cdc": zeros(n, 2, 4),
            "cac": zeros(n, 2, 4, 16), "cnnz": zeros(n, 2, 4),
        }
        # the lane lists of every wave, uploaded once
        lanes = _wave_lanes(mb_w, mb_h)
        flat_y = torch.tensor([y for ys, _ in lanes for y in ys], device=dev)
        flat_x = torch.tensor([x for _, xs in lanes for x in xs], device=dev)
        self.waves, start = [], 0
        for ys_l, _xs_l in lanes:
            B = len(ys_l)
            self.waves.append((B, flat_y[start:start + B],
                               flat_x[start:start + B]))
            start += B
        self.m_top = on(_M_TOP, dev)
        self.m_left = on(_M_LEFT, dev)
        self.m_all3 = on(_M_ALL3, dev)
        self.m_dc = on(_M_DC, dev)
        self.ar9 = torch.arange(9, device=dev)
        self.a21 = torch.arange(21, device=dev)
        self.a16 = torch.arange(16, device=dev)
        self.a9 = torch.arange(9, device=dev)
        self.a8 = torch.arange(8, device=dev)
        self.yy16, self.xx16 = torch.meshgrid(self.a16, self.a16,
                                              indexing="ij")
        self.yy8, self.xx8 = torch.meshgrid(self.a8, self.a8, indexing="ij")
        self.iw = torch.arange(1, 9, device=dev)
        self.iw4 = torch.arange(1, 5, device=dev)
        self.quad_w = on(_QUAD_BITS, dev)
        self.graphs = []              # one CUDA graph per wave (_graphed)
        self.pool = None

    def load(self, origY, origU, origV) -> None:
        """A new picture: the source planes copied in, the recon and the
        decided fields reset to a fresh call's."""
        self.o32.copy_(origY)
        self.oU.copy_(origU)
        self.oV.copy_(origV)
        for t in (self.recY, self.recU, self.recV):
            t.zero_()
        for k, t in self.out.items():
            t.fill_(-1 if k in ("i4m", "i16m") else 0)

    def result(self) -> dict:
        h, w = self.mb_h * 16, self.mb_w * 16
        out = {k: t.clone() for k, t in self.out.items()}
        out["recY"] = self.recY[1:1 + h, 1:1 + w].to(torch.uint8)
        out["recU"] = self.recU[1:1 + h // 2, 1:1 + w // 2].to(torch.uint8)
        out["recV"] = self.recV[1:1 + h // 2, 1:1 + w // 2].to(torch.uint8)
        return out


def _wave(st: _WaveState, B: int, ys, xs) -> None:
    """One wave: the B MBs (ys, xs) coded at once, their recon and fields
    committed to st."""
    dev, mb_w, qpc, lam, lam4, qpv = (st.dev, st.mb_w, st.qpc, st.lam,
                                      st.lam4, st.qpv)
    o32, oU, oV, recY, recU, recV, out = (st.o32, st.oU, st.oV, st.recY,
                                          st.recU, st.recV, st.out)
    m_top, m_left, m_all3, m_dc = st.m_top, st.m_left, st.m_all3, st.m_dc
    ar9, a21, a16, a9, a8 = st.ar9, st.a21, st.a16, st.a9, st.a8
    yy16, xx16, yy8, xx8 = st.yy16, st.xx16, st.yy8, st.xx8
    iw, iw4, quad_w = st.iw, st.iw4, st.quad_w
    big = 1 << 28
    addr = ys * mb_w + xs
    px, py = xs * 16, ys * 16
    av_l = xs > 0
    av_t = ys > 0
    av_tl = av_l & av_t
    av_tr = av_t & (xs < mb_w - 1)

    top_ext = recY[py[:, None], px[:, None] + a21]            # (B, 21)
    left_col = recY[py[:, None] + 1 + a16, px[:, None]]       # (B, 16)
    omb = o32[py[:, None, None] + a16[:, None],
              px[:, None, None] + a16]                        # (B, 16, 16)

    # neighbour-MB I4 modes for the most-probable-mode prediction
    i4m, cls = out["i4m"], out["cls"]
    l_addr = torch.where(av_l, addr - 1, 0)
    t_addr = torch.where(av_t, addr - mb_w, 0)
    lmb = torch.where((cls[l_addr] == 1)[:, None], i4m[l_addr], 2)
    lmb = torch.where(av_l[:, None], lmb, -1)
    tmb = torch.where((cls[t_addr] == 1)[:, None], i4m[t_addr], 2)
    tmb = torch.where(av_t[:, None], tmb, -1)

    # local tile: L[j+1, i+1] = recon pixel (j, i) of the MB
    L = torch.zeros((B, 17, 21), dtype=I32, device=dev)
    L[:, 0, :] = top_ext
    L[:, 1:, 0] = left_col
    modes_loc = torch.full((B, 16), -1, dtype=I32, device=dev)
    scans_loc = torch.zeros((B, 16, 16), dtype=I32, device=dev)
    nnz_loc = torch.zeros((B, 16), dtype=I32, device=dev)
    cost4_tot = torch.zeros(B, dtype=torch.int64, device=dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)

    for ci in range(16):
        blk = CODE2RASTER[ci]
        by, bx = blk // 4, blk % 4
        x0, y0b = bx * 4, by * 4
        a_l = ones if bx > 0 else av_l
        a_t = ones if by > 0 else av_t
        if bx > 0 and by > 0:
            a_tl = ones
        elif bx == 0 and by > 0:
            a_tl = av_l
        elif by == 0 and bx > 0:
            a_tl = av_t
        else:
            a_tl = av_tl
        if by == 0:
            a_tr = av_t if bx < 3 else av_tr
        elif bx == 3:
            a_tr = ~ones
        else:
            a_tr = ones if RASTER2CODE[(by - 1) * 4 + bx + 1] < ci \
                else ~ones
        top8 = L[:, y0b, x0 + 1:x0 + 9]
        top8 = torch.where(a_tr[:, None], top8, torch.cat(
            [top8[:, :4], top8[:, 3:4].expand(B, 4)], dim=1))
        top8 = torch.where(a_t[:, None], top8, 0)
        left4 = torch.where(a_l[:, None], L[:, y0b + 1:y0b + 5, x0], 0)
        corner = torch.where(a_tl, L[:, y0b, x0], 0)
        rr = torch.cat([torch.flip(left4, [1]), corner[:, None], top8],
                       dim=1)                                  # (B, 13)
        preds = i4_predict_all(rr, a_t, a_l)                   # (B, 9, 16)
        ob = omb[:, y0b:y0b + 4, x0:x0 + 4].reshape(B, 1, 16)
        sad = torch.abs(ob - preds).sum(-1)                    # (B, 9)
        ma = modes_loc[:, blk - 1] if bx > 0 else lmb[:, blk + 3]
        mb_ = modes_loc[:, blk - 4] if by > 0 else tmb[:, blk + 12]
        mpm = torch.where((ma < 0) | (mb_ < 0), 2,
                          torch.minimum(ma, mb_))
        cost = sad + lam4 * (ar9 != mpm[:, None]).to(I32)
        ok = (m_dc[None] | (m_top[None] & a_t[:, None])
              | (m_left[None] & a_l[:, None])
              | (m_all3[None] & (a_t & a_l & a_tl)[:, None]))
        cost = torch.where(ok, cost, big)
        mn, best_m = cost.min(dim=1)
        cost4_tot += mn
        pred = torch.gather(preds, 1, best_m[:, None, None]
                            .expand(B, 1, 16))[:, 0].reshape(B, 4, 4)
        scan, nnz, rec = _code_i4_block(
            omb[:, y0b:y0b + 4, x0:x0 + 4], pred, qpv)
        modes_loc[:, blk] = best_m.to(I32)
        scans_loc[:, blk] = scan
        nnz_loc[:, blk] = nnz
        L[:, y0b + 1:y0b + 5, x0 + 1:x0 + 5] = rec

    # ---- I16 candidate --------------------------------------------
    t16 = top_ext[:, 1:17]
    l16 = left_col
    cnr = top_ext[:, 0]
    st = t16.sum(1)
    sl = l16.sum(1)
    dc16 = torch.where(av_t & av_l, (st + sl + 16) >> 5,
                       torch.where(av_t, (st + 8) >> 4,
                                   torch.where(av_l, (sl + 8) >> 4, 128)))
    tt = torch.cat([cnr[:, None], t16], dim=1)
    ll = torch.cat([cnr[:, None], l16], dim=1)
    hh = (iw * (tt[:, 8 + iw] - tt[:, 8 - iw])).sum(1)
    vv = (iw * (ll[:, 8 + iw] - ll[:, 8 - iw])).sum(1)
    a_ = 16 * (l16[:, 15] + t16[:, 15])
    b_ = (5 * hh + 32) >> 6
    c_ = (5 * vv + 32) >> 6
    p_pl = torch.clamp((a_[:, None, None] + b_[:, None, None] * (xx16 - 7)
                        + c_[:, None, None] * (yy16 - 7) + 16) >> 5,
                       0, 255)
    cands = torch.stack([t16[:, None, :].expand(B, 16, 16),
                         l16[:, :, None].expand(B, 16, 16),
                         dc16[:, None, None].expand(B, 16, 16),
                         p_pl], dim=1)                         # (B, 4, 16, 16)
    sad16 = torch.abs(omb[:, None] - cands).sum((-2, -1))
    okm = torch.stack([av_t, av_l, ones, av_t & av_l & av_tl], dim=1)
    sad16 = torch.where(okm, sad16, big)
    cost16, m16 = sad16.min(dim=1)
    pred16 = torch.gather(cands, 1, m16[:, None, None, None]
                          .expand(B, 1, 16, 16))[:, 0]

    blocks16 = (omb - pred16).reshape(B, 4, 4, 4, 4) \
        .permute(0, 1, 3, 2, 4).reshape(B, 16, 4, 4)
    w16 = T.forward4x4(blocks16)
    qpb = qpv.expand(B, 16)
    dc_t = T.hadamard4x4(w16[:, :, 0, 0].reshape(B, 4, 4)) >> 1
    dc_lev = Q.quant_luma_dc(dc_t, qpv.expand(B))
    dc_scan = to_scan(dc_lev)
    ac_scan = to_scan(Q.quant_4x4(w16, qpb, True))
    ac_scan[..., 0] = 0
    nnz16 = (ac_scan[..., 1:] != 0).sum(-1).to(I32)
    has_ac = nnz16.sum(1) > 0
    ac_scan = torch.where(has_ac[:, None, None], ac_scan, 0)
    nnz16 = torch.where(has_ac[:, None], nnz16, 0)
    cbp16_luma = torch.where(has_ac, 15, 0)
    d16 = Q.dequant_4x4(from_scan(ac_scan), qpb)
    dc_it = T.hadamard4x4(from_scan(dc_scan))
    dc_s = Q.rshift_rnd_sf((dc_it * Q.dc_scale(qpv)) << (qpv // 6), 6)
    d16[:, :, 0, 0] = dc_s.reshape(B, 16)
    r16 = T.inverse4x4_round(d16)
    pred_b16 = pred16.reshape(B, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(B, 16, 4, 4)
    rec16 = torch.clamp(pred_b16 + r16, 0, 255).reshape(B, 4, 4, 4, 4) \
        .permute(0, 1, 3, 2, 4).reshape(B, 16, 16)

    # ---- I16 vs I4 (md_low rule) -------------------------------------
    use16 = cost16 + 24 * lam < cost4_tot
    recL = torch.where(use16[:, None, None], rec16, L[:, 1:, 1:17])
    nnzq = nnz_loc[:, on(_QB, dev)].sum(-1)
    cbp4_luma = ((nnzq > 0).to(I32) * quad_w).sum(1)
    cls_out = torch.where(use16, 2, 1)
    cbp_luma = torch.where(use16, cbp16_luma, cbp4_luma)
    modes_out = torch.where(use16[:, None], -1, modes_loc)
    lcoef_out = torch.where(use16[:, None, None], ac_scan, scans_loc)
    lnnz_out = torch.where(use16[:, None], nnz16, nnz_loc)
    ldc_out = torch.where(use16[:, None], dc_scan, 0)
    i16_out = torch.where(use16, m16, -1)

    # ---- chroma intra ----------------------------------------------
    cx, cy = xs * 8, ys * 8
    ctopU = recU[cy[:, None], cx[:, None] + a9]
    ctopV = recV[cy[:, None], cx[:, None] + a9]
    cleftU = recU[cy[:, None] + 1 + a8, cx[:, None]]
    cleftV = recV[cy[:, None] + 1 + a8, cx[:, None]]
    cmbU = oU[cy[:, None, None] + a8[:, None], cx[:, None, None] + a8]
    cmbV = oV[cy[:, None, None] + a8[:, None], cx[:, None, None] + a8]

    def chroma_cands(ctop, cleft):
        t8 = ctop[:, 1:]
        l8 = cleft
        ts = t8.reshape(B, 2, 4).sum(-1)
        ls = l8.reshape(B, 2, 4).sum(-1)
        both = av_t & av_l

        def dcv(pos, tsv, lsv):
            if pos in (0, 3):
                return torch.where(both, (tsv + lsv + 4) >> 3,
                                   torch.where(av_t, (tsv + 2) >> 2,
                                               torch.where(av_l, (lsv + 2) >> 2,
                                                           128)))
            if pos == 1:
                return torch.where(av_t, (tsv + 2) >> 2,
                                   torch.where(av_l, (lsv + 2) >> 2, 128))
            return torch.where(av_l, (lsv + 2) >> 2,
                               torch.where(av_t, (tsv + 2) >> 2, 128))

        p_dc = torch.zeros((B, 8, 8), dtype=torch.int64, device=dev)
        for byy in range(2):
            for bxx in range(2):
                pos = (0 if bxx == 0 else 1) if byy == 0 \
                    else (2 if bxx == 0 else 3)
                p_dc[:, byy * 4:byy * 4 + 4, bxx * 4:bxx * 4 + 4] = \
                    dcv(pos, ts[:, bxx], ls[:, byy])[:, None, None]
        ll_ = torch.cat([ctop[:, :1], l8], dim=1)
        hh_ = (iw4 * (ctop[:, 4 + iw4] - ctop[:, 4 - iw4])).sum(1)
        vv_ = (iw4 * (ll_[:, 4 + iw4] - ll_[:, 4 - iw4])).sum(1)
        a_c = 16 * (l8[:, 7] + t8[:, 7])
        b_c = (34 * hh_ + 32) >> 6
        c_c = (17 * vv_ + 16) >> 5
        p_pl = torch.clamp((a_c[:, None, None] + b_c[:, None, None] * (xx8 - 3)
                            + c_c[:, None, None] * (yy8 - 3) + 16) >> 5,
                           0, 255)
        return torch.stack([p_dc, l8[:, :, None].expand(B, 8, 8),
                            t8[:, None, :].expand(B, 8, 8), p_pl], dim=1)

    candU = chroma_cands(ctopU, cleftU)
    candV = chroma_cands(ctopV, cleftV)
    csad = (torch.abs(cmbU[:, None] - candU).sum((-2, -1))
            + torch.abs(cmbV[:, None] - candV).sum((-2, -1)))
    okc = torch.stack([ones, av_l, av_t, av_t & av_l & av_tl], dim=1)
    csad = torch.where(okc, csad, big)
    cmode = torch.argmin(csad, dim=1)
    sel = cmode[:, None, None, None].expand(B, 1, 8, 8)
    predU = torch.gather(candU, 1, sel)[:, 0]
    predV = torch.gather(candV, 1, sel)[:, 0]
    cdc, cac, cnnz, cbp_c, rU, rV = chroma_residual(
        cmbU, cmbV, predU, predV, qpc, True)

    # ---- commit the wave --------------------------------------------
    recY[py[:, None, None] + 1 + a16[:, None],
         px[:, None, None] + 1 + a16] = recL.to(I32)
    recU[cy[:, None, None] + 1 + a8[:, None],
         cx[:, None, None] + 1 + a8] = rU.to(I32)
    recV[cy[:, None, None] + 1 + a8[:, None],
         cx[:, None, None] + 1 + a8] = rV.to(I32)
    out["cls"][addr] = cls_out.to(I32)
    out["i4m"][addr] = modes_out.to(I32)
    out["i16m"][addr] = i16_out.to(I32)
    out["cmode"][addr] = cmode.to(I32)
    out["cbp"][addr] = ((cbp_c << 4) | cbp_luma).to(I32)
    out["lcoef"][addr] = lcoef_out.to(I32)
    out["ldc"][addr] = ldc_out.to(I32)
    out["lnnz"][addr] = lnnz_out.to(I32)
    out["cdc"][addr] = cdc
    out["cac"][addr] = cac
    out["cnnz"][addr] = cnnz


# the per-size, per-QP wave states whose CUDA graphs later pictures replay
# (at most _GRAPH_KEYS, the oldest dropped first)
_GRAPH_STATES: dict = {}
_GRAPH_KEYS = 8


def _graphed(st: _WaveState) -> None:
    """Every wave of st on the card: replayed from its CUDA graph, or, the
    first time, captured and then replayed (the graphs share one memory
    pool: they always replay in the order of their capture). The first
    wave runs as is before its capture, which leaves every constant table
    of the waves on the card and the libraries initialized: nothing in a
    capture may copy from the host. A graph replays the same kernels on
    the same tensors as the eager wave, with no host work: the waves'
    cost is their launches."""
    if st.pool is None:
        st.pool = torch.cuda.graph_pool_handle()
    cur = torch.cuda.current_stream(st.dev)
    side = None
    for d, (B, ys, xs) in enumerate(st.waves):
        if d < len(st.graphs):
            st.graphs[d].replay()
            continue
        if d == 0:
            _wave(st, B, ys, xs)
        if side is None:
            side = torch.cuda.Stream(st.dev)
        side.wait_stream(cur)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            g.capture_begin(pool=st.pool, capture_error_mode="thread_local")
            _wave(st, B, ys, xs)
            g.capture_end()
        cur.wait_stream(side)
        st.graphs.append(g)
        if d > 0:
            g.replay()


def i_frame_step(origY, origU, origV, qp: int, qpc: int, lam: int,
                 lam4: int, *, mb_w: int, mb_h: int):
    """Encode a whole I picture. origY (16 mb_h, 16 mb_w) uint8, origU /
    origV (8 mb_h, 8 mb_w) uint8. Returns the decided SoA fields (int32):
    cls (N,) 1 = I4 / 2 = I16, i4m (N, 16), i16m (N,), cmode (N,), cbp
    (N,), lcoef (N, 16, 16), ldc (N, 16), lnnz (N, 16), cdc (N, 2, 4),
    cac (N, 2, 4, 16), cnnz (N, 2, 4); and recY / recU / recV uint8. On a
    CUDA card the waves of the second and later pictures of a size and QP
    are replays of the first one's CUDA graphs (_graphed)."""
    dev = origY.device
    if dev.type != "cuda":
        st = _WaveState(dev, qp, qpc, lam, lam4, mb_w, mb_h)
        st.load(origY, origU, origV)
        for B, ys, xs in st.waves:
            _wave(st, B, ys, xs)
        return st.result()
    key = (str(dev), qp, qpc, lam, lam4, mb_w, mb_h)
    st = _GRAPH_STATES.pop(key, None)
    if st is None:
        st = _WaveState(dev, qp, qpc, lam, lam4, mb_w, mb_h)
        while len(_GRAPH_STATES) >= _GRAPH_KEYS:
            _GRAPH_STATES.pop(next(iter(_GRAPH_STATES)))
    _GRAPH_STATES[key] = st
    st.load(origY, origU, origV)
    _graphed(st)
    return st.result()
