"""In-loop deblocking filter on tensors (spec 8.7), twin of
jm_tpu/ops/deblock_jax.py and of the Pallas kernels in
jm_tpu/ops/deblock_pallas.py.

- ``compute_bs``: boundary strengths from the per-MB SoA state (mixed
  intra/inter, so the IDR frame uses it too);
- ``deblock_plain``: the plain PyTorch wavefront, built on the per-MB
  tile steps ``luma_vertical`` / ``luma_horizontal`` and their chroma
  twins;
- ``deblock``: the public entry. CUDA tensors go to the hand-written
  kernels (jm_tpu_torch/kernels/deblock.cu, one persistent launch each;
  the 8-bit kernels for uint8 planes, their >8-bit variants for int16
  planes); CPU tensors go to ``deblock_plain``. Nothing falls back from
  one to the other.

Above 8 bits (bd = (luma, chroma) bit depths, 9-14) alpha, beta and tC0
are the tables' values times 1 << (bitDepth - 8) (spec 8.7.2.2), the
filtered samples are clipped at (1 << bitDepth) - 1, and QPY and QPc may
be negative: the QP -> QPc tables of convert.qpc_tables are indexed at
QPY + QpBdOffsetY (their length less 52), as jm_tpu's host
deblock_picture(bd=) does (jm_tpu/ops/deblock.py:227-380).

Wavefront: macroblock (b, c) depends on its left (b, c-1) and top
(b-1, c) neighbours and on (b-1, c+1), whose left-edge filter touches
the top MB's right columns. Wave w holds the MBs (b, w - 2b)
(lencod/src/loopFilter.c:112 DeblockFrame builds the same 2:1
diagonals), so n_w = mb_w + 2 (mb_h - 1) waves run in order and the MBs
of one wave touch disjoint pixels. Per MB the order is DeblockMb's: four
vertical edges left to right, then four horizontal edges top to bottom;
MB-edge filters modify the neighbours' 3-pixel fringes in place. The
kernels walk the same dependency row by row: the vertical edges of
(b, c) need only (b, c-1), and its horizontal edges need MB (b-1, c)
final, i.e. also the vertical edges of (b-1, c+1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.tables import ALPHA_TABLE, BETA_TABLE, TC0_TABLE
from .consts import on

ALPHA = np.asarray(ALPHA_TABLE, np.int32)
BETA = np.asarray(BETA_TABLE, np.int32)
TC0 = np.asarray(TC0_TABLE, np.int32).reshape(-1)      # (3*52,)

I32 = torch.int32


def n_waves(mb_w: int, mb_h: int) -> int:
    """Number of 2:1 diagonal waves covering an mb_w x mb_h frame."""
    return mb_w + 2 * (mb_h - 1) if mb_h > 1 else mb_w


# ---------------------------------------------------------------------------
# boundary strengths
# ---------------------------------------------------------------------------

def compute_bs(mb_class, luma_nnz, transform8x8, mv, mv_l1, ref_pic_id,
               ref_pic_id_l1, mb_w: int, mb_h: int, field: bool = False,
               sp_slice=None):
    """Boundary strengths (spec 8.7.2.1) of a frame picture, or with
    field of a field picture: its vertical MV components differ from 2
    quarter samples up (half the vertical resolution, ldecod
    loop_filter.c mvlimit) and its horizontal MB edges next to an intra
    MB take bS 3, not 4 (loop_filter_normal.c:124; jm_tpu
    ops/deblock.py:58-60, :103-105).

    mb_class (N,) (0 inter, else intra); luma_nnz (N, 16) raster 4x4
    counts; transform8x8 (N,); mv / mv_l1 (N, 16, 2) quarter-pel;
    ref_pic_id / ref_pic_id_l1 (N, 4) per-8x8 picture ids (-1 none);
    sp_slice None or (N,) bool, the MBs of SP slices: every edge whose q
    side lies in one takes bS 4 on an MB edge (3 on a field's horizontal
    one) and 3 inside the MB, the picture's border staying 0 (spec
    8.7.2.1; jm_tpu ops/deblock.py:108-122, ldecod
    loop_filter_normal.c:100, :230). Returns (bs_v, bs_h), each (4 mb_h, 4 mb_w) int8: bs_v[y, x] is the
    strength of the vertical edge left of 4x4 block (y, x), bs_h of the
    horizontal edge above it (column/row 0 stays 0)."""
    H, W = 4 * mb_h, 4 * mb_w
    dev = luma_nnz.device
    mc = mb_class.reshape(mb_h, mb_w)
    intra = (mc != 0).repeat_interleave(4, 0).repeat_interleave(4, 1)
    t8 = transform8x8.to(torch.bool)
    q = luma_nnz.to(I32).reshape(-1, 2, 2, 2, 2)
    qa = q.sum(dim=(2, 4), keepdim=True).expand(q.shape)
    nnz_mb = torch.where(t8[:, None, None, None, None], qa, q).reshape(-1, 16)
    nnz = nnz_mb.reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3).reshape(H, W)
    mv0 = mv.to(I32).reshape(mb_h, mb_w, 4, 4, 2).permute(0, 2, 1, 3, 4) \
        .reshape(H, W, 2)
    mv1 = mv_l1.to(I32).reshape(mb_h, mb_w, 4, 4, 2).permute(0, 2, 1, 3, 4) \
        .reshape(H, W, 2)

    def expand_q(a8):
        return a8.reshape(mb_h, mb_w, 2, 2).permute(0, 2, 1, 3) \
            .reshape(2 * mb_h, 2 * mb_w) \
            .repeat_interleave(2, 0).repeat_interleave(2, 1)

    r0 = expand_q(ref_pic_id.to(torch.int64))
    r1 = expand_q(ref_pic_id_l1.to(torch.int64))

    mv_lim = torch.tensor([4, 2 if field else 4], dtype=I32, device=dev)

    def cmp_mv(a, b):
        return (torch.abs(a - b) >= mv_lim).any(dim=-1)

    def edge_bs(sl_p, sl_q, is_mb_edge, mb_edge_bs=4):
        (ip, nn_p, m0p, m1p, r0p, r1p) = sl_p
        (iq, nn_q, m0q, m1q, r0q, r1q) = sl_q
        either_intra = ip | iq
        coef = (nn_p > 0) | (nn_q > 0)
        pair_straight = (r0p == r0q) & (r1p == r1q)
        pair_cross = (r0p == r1q) & (r1p == r0q)
        c00 = cmp_mv(m0p, m0q)
        c11 = cmp_mv(m1p, m1q)
        c01 = cmp_mv(m0p, m1q)
        c10 = cmp_mv(m1p, m0q)
        strv_same = (c00 | c11) & (c01 | c10)
        strv = torch.where(~(pair_straight | pair_cross), True,
                           torch.where(r0p != r1p,
                                       torch.where(r0p == r0q, c00 | c11,
                                                   c01 | c10),
                                       strv_same)).to(torch.int8)
        edge = torch.where(is_mb_edge, mb_edge_bs, 3).to(torch.int8)
        return torch.where(either_intra, edge,
                           torch.where(coef, torch.full_like(strv, 2), strv))

    fields = (intra, nnz, mv0, mv1, r0, r1)
    is_mb_v = torch.zeros((H, W - 1), dtype=torch.bool, device=dev)
    is_mb_v[:, 3::4] = True
    bs_v = torch.zeros((H, W), dtype=torch.int8, device=dev)
    bs_v[:, 1:] = edge_bs(tuple(a[:, :-1] for a in fields),
                          tuple(a[:, 1:] for a in fields), is_mb_v)
    is_mb_h = torch.zeros((H - 1, W), dtype=torch.bool, device=dev)
    is_mb_h[3::4, :] = True
    bs_h = torch.zeros((H, W), dtype=torch.int8, device=dev)
    hor_mb_bs = 3 if field else 4
    bs_h[1:, :] = edge_bs(tuple(a[:-1] for a in fields),
                          tuple(a[1:] for a in fields), is_mb_h, hor_mb_bs)
    if sp_slice is not None:
        spq = sp_slice.to(torch.bool).reshape(mb_h, mb_w) \
            .repeat_interleave(4, 0).repeat_interleave(4, 1)
        mb_col = (torch.arange(W, device=dev) % 4 == 0)[None, :]
        mb_row = (torch.arange(H, device=dev) % 4 == 0)[:, None]
        three = torch.full_like(bs_v, 3)
        bs_v = torch.where(spq, torch.where(mb_col, 4, three), bs_v)
        bs_h = torch.where(spq, torch.where(mb_row, hor_mb_bs, three), bs_h)
        bs_v[:, 0] = 0
        bs_h[0, :] = 0
    return bs_v, bs_h


# ---------------------------------------------------------------------------
# edge filters (int32, one filter line per row of the last-but-one axis)
# ---------------------------------------------------------------------------

def _luma_edge(cols, bs, alpha, beta, tc0, enable, strong=True,
               cmax: int = 255):
    """cols (..., 8) int32 = [p3 p2 p1 p0 q0 q1 q2 q3]; bs / tc0 per line,
    alpha / beta / enable broadcastable. Returns the filtered (..., 8).
    strong=False when no line has bS 4: the strong filter is not
    computed (its lines would be selected by nothing). cmax: the sample
    maximum, (1 << bitDepth) - 1."""
    p3, p2, p1, p0 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    q0, q1, q2, q3 = cols[..., 4], cols[..., 5], cols[..., 6], cols[..., 7]
    fflag = ((torch.abs(p0 - q0) < alpha) & (torch.abs(p1 - p0) < beta)
             & (torch.abs(q1 - q0) < beta) & (bs > 0) & enable)
    ap = torch.abs(p2 - p0) < beta
    aq = torch.abs(q2 - q0) < beta

    tc = tc0 + ap.to(I32) + aq.to(I32)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = torch.clamp(p0 + delta, 0, cmax)
    nq0 = torch.clamp(q0 - delta, 0, cmax)
    np1 = p1 + torch.clamp((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1,
                           -tc0, tc0)
    nq1 = q1 + torch.clamp((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1,
                           -tc0, tc0)
    np1 = torch.where(ap, np1, p1)
    nq1 = torch.where(aq, nq1, q1)
    if not strong:
        out = [torch.where(fflag, o, v) for o, v in zip(
            (np1, np0, nq0, nq1), (p1, p0, q0, q1))]
        return torch.stack([p3, p2, *out, q2, q3], dim=-1)

    strong = torch.abs(p0 - q0) < ((alpha >> 2) + 2)
    sap = strong & ap
    saq = strong & aq
    sp0 = torch.where(sap, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    sp1 = torch.where(sap, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = torch.where(sap, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = torch.where(saq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    sq1 = torch.where(saq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = torch.where(saq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    out = [torch.where(is4, sp2, p2), torch.where(is4, sp1, np1),
           torch.where(is4, sp0, np0), torch.where(is4, sq0, nq0),
           torch.where(is4, sq1, nq1), torch.where(is4, sq2, q2)]
    orig = [p2, p1, p0, q0, q1, q2]
    out = [torch.where(fflag, o, v) for o, v in zip(out, orig)]
    return torch.stack([p3, *out, q3], dim=-1)


def _chroma_edge(cols, bs, alpha, beta, tc0, enable, cmax: int = 255):
    """cols (..., 4) int32 = [p1 p0 q0 q1]; only p0 / q0 change, clipped
    at cmax."""
    p1, p0, q0, q1 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    fflag = ((torch.abs(p0 - q0) < alpha) & (torch.abs(p1 - p0) < beta)
             & (torch.abs(q1 - q0) < beta) & (bs > 0) & enable)
    tc = tc0 + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = torch.clamp(p0 + delta, 0, cmax)
    nq0 = torch.clamp(q0 - delta, 0, cmax)
    sp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    rp0 = torch.where(fflag, torch.where(is4, sp0, np0), p0)
    rq0 = torch.where(fflag, torch.where(is4, sq0, nq0), q0)
    return torch.stack([p1, rp0, rq0, q1], dim=-1)


# ---------------------------------------------------------------------------
# the plain wavefront
# ---------------------------------------------------------------------------

def _neighbor(v2d, axis: int):
    """Left (axis=1) / top (axis=0) neighbour value, self at the border."""
    if axis == 1:
        return torch.cat([v2d[:, :1], v2d[:, :-1]], dim=1)
    return torch.cat([v2d[:1], v2d[:-1]], dim=0)


class MbParams:
    """Per-MB filter state of one picture, shared by both plain passes:
    qp, offsets, the MB / left / top edge enables, neighbour qps."""

    def __init__(self, qp, disable, a_off, b_off, slice_id, transform8x8,
                 mb_w: int, mb_h: int):
        dev = qp.device
        self.qp = qp.to(I32).reshape(mb_h, mb_w)
        dis = disable.to(I32).reshape(mb_h, mb_w)
        self.ao = a_off.to(I32).reshape(mb_h, mb_w)
        self.bo = b_off.to(I32).reshape(mb_h, mb_w)
        sid = slice_id.to(I32).reshape(mb_h, mb_w)
        self.t8 = transform8x8.to(I32).reshape(mb_h, mb_w) != 0
        self.on = dis != 1
        col = torch.arange(mb_w, device=dev)[None, :]
        row = torch.arange(mb_h, device=dev)[:, None]
        self.left_ok = self.on & (col > 0) & \
            ~((dis == 2) & (_neighbor(sid, 1) != sid))
        self.top_ok = self.on & (row > 0) & \
            ~((dis == 2) & (_neighbor(sid, 0) != sid))
        self.qp_l = _neighbor(self.qp, 1)
        self.qp_t = _neighbor(self.qp, 0)
        self.mb_w, self.mb_h = mb_w, mb_h

    def lanes(self, bb, cc, bs_v, bs_h):
        """The MBs (bb, cc) as lanes: (per-lane params, bv, bh) where bv /
        bh (B, 4 edges, 4 block lines) are the lanes' bS."""
        a4 = torch.arange(4, device=bb.device)
        lane = {k: getattr(self, k)[bb, cc] for k in (
            "qp", "qp_l", "qp_t", "ao", "bo", "on", "left_ok", "top_ok",
            "t8")}
        bv = bs_v.to(I32)[(4 * bb)[:, None, None] + a4[None, None, :],
                          (4 * cc)[:, None, None] + a4[None, :, None]]
        bh = bs_h.to(I32)[(4 * bb)[:, None, None] + a4[None, :, None],
                          (4 * cc)[:, None, None] + a4[None, None, :]]
        return lane, bv, bh

    def waves(self, bs_v, bs_h):
        """Per wave with an MB that has an edge of bS > 0: (bb, cc,
        *self.lanes(bb, cc, ...)) of those MBs. An MB whose 32 edges all
        have bS 0 is left out: no filter changes a sample there (every
        filter's flag needs bS > 0), and the MBs of a wave touch disjoint
        samples."""
        b_all = torch.arange(self.mb_h, device=self.qp.device)
        live = ((bs_v > 0) | (bs_h > 0)).reshape(
            self.mb_h, 4, self.mb_w, 4).any(dim=3).any(dim=1)
        for wv in range(n_waves(self.mb_w, self.mb_h)):
            c_all = wv - 2 * b_all
            valid = (c_all >= 0) & (c_all < self.mb_w)
            valid &= live[b_all, c_all.clamp(0, self.mb_w - 1)]
            if not bool(valid.any()):
                continue
            bb, cc = b_all[valid], c_all[valid]
            yield (bb, cc, *self.lanes(bb, cc, bs_v, bs_h))


def _thresholds(qp_p, qp_q, ao, bo, dev, bd: int = 8):
    """alpha, beta (B, 1), scaled to bd bits, and the index A (B, 1) of a
    QP pair (which may be negative above 8 bits: indexA clips at 0)."""
    qav = (qp_p + qp_q + 1) >> 1
    ia = torch.clamp(qav + 2 * ao, 0, 51)
    ib = torch.clamp(qav + 2 * bo, 0, 51)
    return (on(ALPHA, dev)[ia.long()][:, None] << (bd - 8),
            on(BETA, dev)[ib.long()][:, None] << (bd - 8), ia[:, None])


def _tc0(bs_line, ia, bd: int = 8):
    return on(TC0, bs_line.device)[((torch.clamp(bs_line, 1, 3) - 1) * 52
                                    + ia).long()] << (bd - 8)


def luma_vertical(tile, ln, bv, bd: int = 8):
    """Filters the 4 vertical edges, left to right, of the 20x20 int32
    tiles (B, 20, 20) of B MBs in place (each MB with the 4 samples left
    of and above it). ln, bv: the MBs' ``MbParams.lanes``; bd the luma
    bit depth."""
    dev = tile.device
    inner = ln["on"] & ~ln["t8"]
    th = [_thresholds(qp_p, ln["qp"], ln["ao"], ln["bo"], dev, bd)
          for qp_p in (ln["qp_l"], ln["qp"])]     # the MB edge, the inner
    has4 = (bv == 4).any(dim=2).any(dim=0).tolist()
    live = (bv > 0).any(dim=2).any(dim=0).tolist()
    for ex in range(4):
        if not live[ex]:            # every line bS 0: nothing filtered
            continue
        en = ln["left_ok"] if ex == 0 else (inner if ex in (1, 3)
                                            else ln["on"])
        al, be, ia = th[ex > 0]
        bs_line = bv[:, ex].repeat_interleave(4, dim=1)   # (B, 16)
        x = 4 * ex + 4
        tile[:, 4:20, x - 4:x + 4] = _luma_edge(
            tile[:, 4:20, x - 4:x + 4], bs_line, al, be,
            _tc0(bs_line, ia, bd), en[:, None], has4[ex], (1 << bd) - 1)


def luma_horizontal(tile, ln, bh, bd: int = 8):
    """The 4 horizontal edges, top to bottom, of the tiles of
    ``luma_vertical``; ln, bh: the MBs' ``MbParams.lanes``."""
    dev = tile.device
    inner = ln["on"] & ~ln["t8"]
    th = [_thresholds(qp_p, ln["qp"], ln["ao"], ln["bo"], dev, bd)
          for qp_p in (ln["qp_t"], ln["qp"])]
    has4 = (bh == 4).any(dim=2).any(dim=0).tolist()
    live = (bh > 0).any(dim=2).any(dim=0).tolist()
    for ey in range(4):
        if not live[ey]:
            continue
        en = ln["top_ok"] if ey == 0 else (inner if ey in (1, 3)
                                           else ln["on"])
        al, be, ia = th[ey > 0]
        bs_line = bh[:, ey].repeat_interleave(4, dim=1)
        y = 4 * ey + 4
        rows = tile[:, y - 4:y + 4, 4:20].transpose(1, 2)
        tile[:, y - 4:y + 4, 4:20] = _luma_edge(
            rows, bs_line, al, be, _tc0(bs_line, ia, bd), en[:, None],
            has4[ey], (1 << bd) - 1).transpose(1, 2)


def deblock_luma_plain(Y, bs_v, bs_h, qp, disable, a_off, b_off, slice_id,
                       transform8x8, *, mb_w: int, mb_h: int, bd: int = 8):
    """Plain twin of the luma kernel (K1, and K1-HBD above 8 bits:
    bd): returns the filtered Y in its dtype. Works
    on an int32 copy padded by 4 samples top/left; per wave it gathers
    every MB's 20x20 tile (the MB plus its left / top fringes), filters
    it (``luma_vertical``, then ``luma_horizontal``) and scatters the
    tiles back (tiles of one wave are disjoint)."""
    dev = Y.device
    h, w = 16 * mb_h, 16 * mb_w
    Yp = torch.zeros((h + 4, w + 4), dtype=I32, device=dev)
    Yp[4:, 4:] = Y.to(I32)
    mp = MbParams(qp, disable, a_off, b_off, slice_id, transform8x8,
                  mb_w, mb_h)
    a20 = torch.arange(20, device=dev)
    for bb, cc, ln, bv, bh in mp.waves(bs_v, bs_h):
        ry = (16 * bb)[:, None, None] + a20[None, :, None]
        rx = (16 * cc)[:, None, None] + a20[None, None, :]
        tile = Yp[ry, rx]                                    # (B, 20, 20)
        luma_vertical(tile, ln, bv, bd)
        luma_horizontal(tile, ln, bh, bd)
        Yp[ry, rx] = tile
    return Yp[4:, 4:].to(Y.dtype)


def _chroma_edges(lines, qp_p, ln, bs_line, en, qpc_cb, qpc_cr,
                  bd: int = 8):
    """Cb and Cr filter lines (B, 2, E, n, 4) across E edges that touch
    disjoint samples, filtered at once: qp_p (B, E) the luma QP of each
    edge's p side (the MB's own is ln["qp"]), bs_line (B, E, n), en (B,
    E) the edge enables; qpc_cb / qpc_cr indexed at QPY + their length
    less 52; bd the chroma bit depth. Returns the filtered lines."""
    dev = lines.device
    off = qpc_cb.shape[0] - 52                                  # QpBdOffsetY
    tabs = torch.stack([qpc_cb.to(I32), qpc_cr.to(I32)])
    qpc_p = tabs[:, (qp_p + off).long()]                        # (2, B, E)
    qpc_q = tabs[:, (ln["qp"] + off).long()][:, :, None]
    qav = (qpc_p + qpc_q + 1) >> 1
    ia = torch.clamp(qav + 2 * ln["ao"][None, :, None], 0, 51) \
        .permute(1, 0, 2)[..., None]                            # (B, 2, E, 1)
    ib = torch.clamp(qav + 2 * ln["bo"][None, :, None], 0, 51) \
        .permute(1, 0, 2)[..., None]
    bs = bs_line[:, None]                                       # (B, 1, E, n)
    return _chroma_edge(lines, bs, on(ALPHA, dev)[ia.long()] << (bd - 8),
                        on(BETA, dev)[ib.long()] << (bd - 8),
                        _tc0(bs, ia, bd), en[:, None, :, None],
                        (1 << bd) - 1)


def chroma_vertical(ct, ln, bv, qpc_cb, qpc_cr, bd: int = 8):
    """Filters vertical edges 0 and 2 of the int32 tiles
    (B, 2, 4 + 4 crows, 12) of B MBs' Cb and Cr in place (each MB with
    the 4 samples left of and above it; crows 2 at 4:2:0, 4 at 4:2:2,
    where each chroma line takes the bS of its own luma line). A chroma
    filter reads two samples on each side and writes one, so the two
    edges (tile columns 2-5 and 6-9) are filtered together. ln, bv: the
    MBs' ``MbParams.lanes``; qpc_cb / qpc_cr the QP -> QPc tables
    (convert.qpc_tables); bd the chroma bit depth."""
    B, n = ct.shape[0], ct.shape[2] - 4                   # 8 or 16 lines
    bs = bv[:, 0::2]
    if not bool((bs > 0).any()):        # every line bS 0: nothing filtered
        return
    lines = ct[:, :, 4:, 2:10].reshape(B, 2, n, 2, 4).permute(0, 1, 3, 2, 4)
    out = _chroma_edges(
        lines, torch.stack([ln["qp_l"], ln["qp"]], 1), ln,
        bs.repeat_interleave(n // 4, dim=2),
        torch.stack([ln["left_ok"], ln["on"]], 1), qpc_cb, qpc_cr, bd)
    ct[:, :, 4:, 2:10] = out.permute(0, 1, 3, 2, 4).reshape(B, 2, n, 8)


def chroma_horizontal(ct, ln, bh, qpc_cb, qpc_cr, bd: int = 8):
    """The horizontal edges of the tiles of ``chroma_vertical``: at
    4:2:0 chroma rows 0 and 4 with the bS of luma edges 0 and 2; at 4:2:2
    rows 0, 4, 8 and 12 with the bS of luma edges 0-3; all of them
    together (tile rows 2 .. n + 1, four per edge). The 8x8 transform
    switches none of them off: at 4:2:2 rows 4 and 12 run although luma
    edges 1 and 3 do not (ldecod loopFilter.c:488)."""
    B, n = ct.shape[0], ct.shape[2] - 4
    k = n // 4                                            # edges
    bs = bh[:, [j * 16 // n for j in range(k)]]
    if not bool((bs > 0).any()):
        return
    lines = ct[:, :, 2:2 + n, 4:12].reshape(B, 2, k, 4, 8).transpose(3, 4)
    out = _chroma_edges(
        lines, torch.cat([ln["qp_t"][:, None],
                          ln["qp"][:, None].expand(B, k - 1)], 1), ln,
        bs.repeat_interleave(2, dim=2),
        torch.cat([ln["top_ok"][:, None],
                   ln["on"][:, None].expand(B, k - 1)], 1),
        qpc_cb, qpc_cr, bd)
    ct[:, :, 2:2 + n, 4:12] = out.transpose(3, 4).reshape(B, 2, n, 8)


def deblock_chroma_plain(U, V, bs_v, bs_h, qp, disable, a_off, b_off,
                         slice_id, transform8x8, qpc_cb, qpc_cr, *,
                         mb_w: int, mb_h: int, bd: int = 8):
    """Plain twin of the chroma kernels (K2 at 4:2:0, K2-422 at 4:2:2,
    and their >8-bit variants: bd the chroma bit depth): returns filtered
    (U, V) of (4 crows mb_h, 8 mb_w) in their dtype, the format read
    from the planes' height. (4 + 4 crows) x 12 tiles per MB and
    component, filtered by ``chroma_vertical``, then
    ``chroma_horizontal``."""
    dev = U.device
    n = chroma_rows(U, mb_h)
    h, w = n * mb_h, 8 * mb_w
    Cp = torch.zeros((2, h + 4, w + 4), dtype=I32, device=dev)
    Cp[0, 4:, 4:] = U.to(I32)
    Cp[1, 4:, 4:] = V.to(I32)
    mp = MbParams(qp, disable, a_off, b_off, slice_id, transform8x8,
                  mb_w, mb_h)
    ay = torch.arange(n + 4, device=dev)
    a12 = torch.arange(12, device=dev)
    for bb, cc, ln, bv, bh in mp.waves(bs_v, bs_h):
        cy = (n * bb)[:, None, None] + ay[None, :, None]
        cx = (8 * cc)[:, None, None] + a12[None, None, :]
        ct = Cp[:, cy, cx].transpose(0, 1)           # (B, 2, n + 4, 12)
        chroma_vertical(ct, ln, bv, qpc_cb, qpc_cr, bd)
        chroma_horizontal(ct, ln, bh, qpc_cb, qpc_cr, bd)
        Cp[:, cy, cx] = ct.transpose(0, 1)
    return Cp[0, 4:, 4:].to(U.dtype), Cp[1, 4:, 4:].to(U.dtype)


def chroma_rows(U, mb_h: int) -> int:
    """Chroma lines per MB of a plane: 8 (4:2:0) or 16 (4:2:2)."""
    n = U.shape[0] // mb_h
    if n not in (8, 16) or U.shape[0] != n * mb_h:
        raise ValueError(f"chroma plane of {U.shape[0]} rows is neither "
                         f"4:2:0 nor 4:2:2 for {mb_h} MB rows")
    return n


def deblock_plain(Y, U, V, bs_v, bs_h, qp, disable, a_off, b_off,
                  slice_id, transform8x8, qpc_cb, qpc_cr, *,
                  mb_w: int, mb_h: int, bd=(8, 8)):
    """The plain PyTorch twin of the deblock kernels (same signature as
    ``deblock``): the luma and the chroma wavefronts."""
    args = (bs_v, bs_h, qp, disable, a_off, b_off, slice_id, transform8x8)
    Yd = deblock_luma_plain(Y, *args, mb_w=mb_w, mb_h=mb_h, bd=bd[0])
    Ud, Vd = deblock_chroma_plain(U, V, *args, qpc_cb, qpc_cr,
                                  mb_w=mb_w, mb_h=mb_h, bd=bd[1])
    return Yd, Ud, Vd


def deblock(Y, U, V, bs_v, bs_h, qp, disable, a_off, b_off, slice_id,
            transform8x8, qpc_cb, qpc_cr, *, mb_w: int, mb_h: int,
            bd=(8, 8)):
    """Deblock a 4:2:0 or 4:2:2 frame picture; returns new (Y, U, V) of
    the planes' dtype.

    Y (16 mb_h, 16 mb_w), U/V (8 mb_h, 8 mb_w) at 4:2:0 or
    (16 mb_h, 8 mb_w) at 4:2:2 (K2-422 on CUDA), uint8 at bd = (8, 8),
    int16 (ops/consts.plane_dtype) when either bit depth is above 8;
    bs_v/bs_h (4 mb_h, 4 mb_w) int8; qp, disable, a_off, b_off,
    slice_id, transform8x8 (N,) int32; qpc_cb / qpc_cr (52 +
    QpBdOffsetY,) int32 QP -> QPc tables (convert.qpc_tables). On CUDA
    the luma and chroma kernels run, their variant chosen by the planes'
    dtype; on the CPU the plain wavefront runs."""
    args = (bs_v, bs_h, qp, disable, a_off, b_off, slice_id, transform8x8)
    if Y.device.type == "cpu":
        return deblock_plain(Y, U, V, *args, qpc_cb, qpc_cr,
                             mb_w=mb_w, mb_h=mb_h, bd=bd)
    from .. import kernels
    Yd = kernels.deblock_luma(Y, *args, mb_w=mb_w, mb_h=mb_h, bd=bd[0])
    Ud, Vd = kernels.deblock_chroma(U, V, *args, qpc_cb, qpc_cr,
                                    mb_w=mb_w, mb_h=mb_h,
                                    crows=chroma_rows(U, mb_h) // 4,
                                    bd=bd[1])
    return Yd, Ud, Vd
