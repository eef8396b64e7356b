"""The decoder's device stages, twin of jm_tpu/ops/dec_jax.py: the
residual decode and the inter reconstruction of every inter macroblock of
a P picture as batched tensor ops, and the same for B pictures, which
jm_tpu reconstructs on the host (decoder/recon.py _recon_inter).

Inter prediction does not depend on the current picture, so every inter
4x4 block of the picture is predicted at once: one gather pulls each
block's 5x5 window of the four quarter-pel planes (INT, B, H, J; see
ops/enc.prep_ref) from the stacked list0 reference states, a 16-way
select applies QPEL_TAB, and chroma takes 3x3 windows with eighth-pel
bilinear weights (ldecod/src/mc_prediction.c get_block_luma:902,
get_block_chroma). Window origins are clamped into the padded planes,
whose replicated border makes the clamp exact for any MV.

A B picture's blocks are predicted from each list in the same way and
combined per 8x8 prediction direction. With weighted prediction (the
optional ``wp`` argument) each 8x8's weights and offsets, made on the
host from the slice tables (decoder/wp.py), are applied to the
predictions before the residual (spec 8.4.2.3), as jm_tpu does on the
host (decoder/recon.py _recon_inter with WPParams.uni / .bi). The
residual decode also takes the 8x8 transform of the MBs that use it
(spec 8.5.13), which jm_tpu reconstructs on the host. Every function runs
on the tensors' device. Scope: 4:2:0 and 4:2:2 frame pictures, and
4:2:0 field pictures (the field scan, and the chroma offset of a
reference field of the other parity), which jm_tpu reconstructs on the
host. At 4:2:2
(crows 4: four rows of chroma 4x4 blocks per MB) the chroma DC is 2x4
(scaled at QPc + 3), each luma 4x4 block covers a 2x4 chroma block, and
the vertical chroma displacement is the luma MV in quarter samples
(spec 8.4.2.2.2), where jm_tpu reconstructs 4:2:2 inter pictures on the
host (decoder/recon.py, _device_recon_ok refuses them). Samples of 9 to
14 bits (``bd``) and lossless MBs, which jm_tpu also reconstructs on the
host, run here too: the residual scaling at QP' = QP + QpBdOffset over
88-row tables (int64 above 8 bits, as jm_tpu's numpy decode), the
transform bypass of the lossless mask, weights with offsets scaled to
the bit depth and clips at (1 << bd) - 1, planes of
ops/consts.plane_dtype (int16 above 8 bits). ``sp_recon`` reconstructs
the inter MBs of SP slices (spec 8.6.1) from their prediction and
levels, which jm_tpu does on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.tables import (DEQUANT_SCALE_4x4, QUANT_SCALE_4x4,
                             SCAN_YUV422, ZIGZAG_8x8, chroma_qp, scan_4x4)
from . import quant as Q
from . import transform as T
from .consts import PAD, QPEL_TAB, on, plane_dtype

I32 = torch.int32
_ZZ8 = np.asarray(ZIGZAG_8x8, np.int64)
# the 4x4 scans by field (spec 8.5.6), kept so that consts.on caches them
_SCAN4 = {f: np.asarray(scan_4x4(f), np.int64) for f in (False, True)}
# SP requantization: the A factors (ldecod quant.h:151, spec 8-425), the
# (de)quant scales by QP % 6 and the QP -> QPc map without a PPS offset
_SP_A = np.array([[16, 20, 16, 20], [20, 25, 20, 25],
                  [16, 20, 16, 20], [20, 25, 20, 25]], np.int64)
_SP_Q = np.asarray(QUANT_SCALE_4x4, np.int64)
_SP_D = np.asarray(DEQUANT_SCALE_4x4, np.int64)
_SP_QPC = np.array([chroma_qp(q, 0) for q in range(52)], np.int64)


def p_dec_residuals(luma_coef, chroma_dc, chroma_coef, qp, tabY, tabU, tabV,
                    qpc_cb, qpc_cr, *, mb_w: int, mb_h: int,
                    luma_coef8=None, transform8x8=None, tab8=None,
                    bd=(8, 8), lossless=None, field: bool = False):
    """Residual decode of a picture's MBs with the inter scaling lists:
    inverse scan (the zig-zag, or with field the field scan of a field
    picture, spec 8.5.6) -> dequant -> rounded inverse 4x4; chroma DC through
    the 2x2 Hadamard (spec 8.5.11); with transform8x8, the luma of those
    MBs through the 8x8 zig-zag, dequant and rounded inverse 8x8 (spec
    8.5.13) in int64, split into their 16 raster 4x4 blocks.

    luma_coef (N, 16, 16) int scan order; chroma_dc (N, 2, 2 crows);
    chroma_coef (N, 2, 2 crows, 16) (crows 2 at 4:2:0, 4 at 4:2:2); qp
    (N,) QPY; tabY / tabU / tabV (88, 4, 4) int32 InvLevelScale by QP'
    (lists 3 / 4 / 5 of decoder/recon.build_inv_scale); qpc_cb / qpc_cr
    (52 + QpBdOffsetY,) int32 QPY -> QPc with the PPS offsets, indexed
    at QPY + QpBdOffsetY (convert.qpc_tables); luma_coef8 (N, 4, 64) 8x8
    scan order, transform8x8 (N,) bool and tab8 (88, 8, 8) int32
    LevelScale8 (list 1 of decoder/recon.build_inv_scale8), all three or
    none. bd = (luma, chroma) bit depths: the scaling runs at QP' = QP +
    QpBdOffset (spec 8.5.8), above 8 bits in int64 as jm_tpu's host
    decode_residuals. lossless: None or the (N,) bool mask of the
    transform-bypass MBs, whose residual is their levels in raster order
    (4x4 and 8x8) with the chroma DC placed raw (jm_tpu
    decoder/recon.py decode_residuals(lossless=)).
    Returns (res_l (N, 16, 4, 4), res_c (N, 2, 2 crows, 4, 4)) int32."""
    n = mb_w * mb_h
    dev = luma_coef.device
    zz = on(_SCAN4[bool(field)], dev)
    qp = qp.to(I32)
    offy, offc = 6 * (bd[0] - 8), 6 * (bd[1] - 8)
    acc = I32 if bd == (8, 8) else torch.int64      # dequant / transform
    qpy = qp + offy                                  # QP'Y

    raster = torch.zeros((n, 16, 16), dtype=I32, device=dev)
    raster[..., zz] = luma_coef.to(I32)
    raster = raster.reshape(n, 16, 4, 4)
    deq = Q.dequant_4x4(raster, qpy[:, None], tabY, acc)
    # jm_tpu keeps the scaled levels as int32 and transforms in int64
    res_l = T.inverse4x4_round(deq.to(I32).to(acc)).to(I32)
    if lossless is not None:
        ll = lossless.to(torch.bool)
        res_l = torch.where(ll[:, None, None, None], raster, res_l)
    if transform8x8 is not None:
        r8 = torch.zeros((n, 4, 64), dtype=torch.int64, device=dev)
        r8[..., on(_ZZ8, dev)] = luma_coef8.to(torch.int64)
        r8 = r8.reshape(n, 4, 8, 8)
        deq8 = Q.dequant_8x8(r8, qpy[:, None], tab8)
        sp8 = T.inverse8x8_round(deq8)
        if lossless is not None:
            sp8 = torch.where(ll[:, None, None, None], r8, sp8)
        res8 = T.split_8x8(sp8).to(I32)
        res_l = torch.where(transform8x8.to(torch.bool)[:, None, None, None],
                            res8, res_l)

    qpi = (qp + offy).long()
    qpu, qpv = qpc_cb[qpi] + offc, qpc_cr[qpi] + offc         # QP'c
    nb = chroma_coef.shape[2]                       # 4 (4:2:0) or 8 (4:2:2)
    craster = torch.zeros((n, 2, nb, 16), dtype=I32, device=dev)
    craster[..., zz] = chroma_coef.to(I32)
    craster = craster.reshape(n, 2, nb, 4, 4)
    dequ = Q.dequant_4x4(craster[:, 0], qpu[:, None], tabU, acc).to(I32)
    deqv = Q.dequant_4x4(craster[:, 1], qpv[:, None], tabV, acc).to(I32)
    if nb == 4:
        f = T.hadamard2x2(chroma_dc.reshape(n, 2, 2, 2).to(acc))
        dequ[:, :, 0, 0] = Q.dequant_chroma_dc(f[:, 0], qpu, tabU) \
            .reshape(n, 4).to(I32)
        deqv[:, :, 0, 0] = Q.dequant_chroma_dc(f[:, 1], qpv, tabV) \
            .reshape(n, 4).to(I32)
    else:
        dequ[:, :, 0, 0] = _chroma_dc422(chroma_dc[:, 0], qpu, tabU)
        deqv[:, :, 0, 0] = _chroma_dc422(chroma_dc[:, 1], qpv, tabV)
    res_c = torch.stack([T.inverse4x4_round(dequ.to(acc)),
                         T.inverse4x4_round(deqv.to(acc))], dim=1).to(I32)
    if lossless is not None:
        raw = craster.clone()
        if nb == 4:
            raw[:, :, :, 0, 0] = chroma_dc.to(I32)
        else:
            # column-major 2x4 placement (ldecod read_comp_cavlc.c:1468)
            for k, (i, j) in enumerate(SCAN_YUV422):
                raw[:, :, 2 * j + i, 0, 0] = chroma_dc[:, :, k].to(I32)
        res_c = torch.where(ll[:, None, None, None, None], raw, res_c)
    return res_l, res_c


def _chroma_dc422(dc, qpc, tab):
    """One component's 4:2:2 chroma DC (spec 8.5.11.2, jm_tpu
    decoder/recon.py decode_residuals): dc (N, 8) in SCAN_YUV422 order
    through the 2-point horizontal and 4-point vertical Hadamard, scaled
    at QPc + 3 with a rounded >> 6, in int64. Returns (N, 8) int32, the
    DC of chroma block 2 row + column."""
    n = dc.shape[0]
    m3 = torch.zeros((n, 2, 4), dtype=torch.int64, device=dc.device)
    for k, (i, j) in enumerate(SCAN_YUV422):
        m3[:, i, j] = dc[:, k].to(torch.int64)
    m4 = torch.stack([m3[:, 0] + m3[:, 1], m3[:, 0] - m3[:, 1]], dim=1)
    m6_0 = m4[..., 0] + m4[..., 2]
    m6_1 = m4[..., 0] - m4[..., 2]
    m6_2 = m4[..., 1] - m4[..., 3]
    m6_3 = m4[..., 1] + m4[..., 3]
    f = torch.stack([m6_0 + m6_3, m6_1 + m6_2, m6_1 - m6_2, m6_0 - m6_3],
                    dim=-1)                                # (N, col, row)
    qpdc = qpc.to(torch.int64) + 3
    scale = tab[qpdc, 0, 0].to(torch.int64)[:, None, None]
    s = Q.rshift_rnd_sf((f * scale) << (qpdc // 6)[:, None, None], 6)
    return s.transpose(1, 2).reshape(n, 8).to(I32)


def _mc_pred(mv, ref_idx, planes_stack, padU_stack, padV_stack, *,
             mb_w: int, mb_h: int, chroma_dy=None):
    """Motion-compensated prediction of every 4x4 block of the picture
    from one list: mv (N, 16, 2) quarter-pel; ref_idx (N, 4) index into
    the stacks per 8x8 (negative entries predict from stack entry 0 and
    are masked by the caller); chroma_dy None or (R,) int, each stack
    entry's offset of the vertical 4:2:0 chroma vector in eighth samples
    (a field picture's reference field of the other parity: -2 below a
    top field, +2 below a bottom one, spec 8.4.1.4; else 0). Returns (luma (N, 16, 4, 4), chroma
    (N, 16, 2, cbh, 2): the Cb and Cr 2 x cbh block of each luma block,
    cbh 2 at 4:2:0 and 4 at 4:2:2, read from the padded planes' height)
    int32."""
    n = mb_w * mb_h
    w, h = 16 * mb_w, 16 * mb_h
    dev = mv.device
    R, _, Hp, Wp = planes_stack.shape
    blk = torch.arange(16, dtype=I32, device=dev)
    bx, by = blk % 4, blk // 4
    quad = ((by // 2) * 2 + bx // 2).long()
    mbi = torch.arange(n, dtype=I32, device=dev)
    px = (mbi % mb_w)[:, None] * 16 + bx[None] * 4           # (N, 16)
    py = (mbi // mb_w)[:, None] * 16 + by[None] * 4
    ref_b = torch.clamp(ref_idx.to(I32)[:, quad], 0, R - 1).long()
    mvx = mv[..., 0].to(I32)
    mvy = mv[..., 1].to(I32)

    # ---- luma: one gather of (N, 16, 4 planes, 5, 5) windows ----------
    x4 = px * 4 + mvx
    y4 = py * 4 + mvy
    xi = torch.clamp(x4 >> 2, -PAD, w + PAD - 5)
    yi = torch.clamp(y4 >> 2, -PAD, h + PAD - 5)
    xf, yf = x4 & 3, y4 & 3
    i5 = torch.arange(5, device=dev)
    p4 = torch.arange(4, device=dev)
    rows = (yi + PAD).long()[..., None, None, None] + i5[:, None]
    cols = (xi + PAD).long()[..., None, None, None] + i5
    idx = ((ref_b[..., None, None, None] * 4 + p4[:, None, None]) * Hp
           + rows) * Wp + cols                                  # (N,16,4,5,5)
    win = planes_stack.reshape(-1)[idx].to(I32)
    pred = torch.zeros((n, 16, 4, 4), dtype=I32, device=dev)
    for (fx, fy), (p1, dx1, dy1, p2, dx2, dy2) in QPEL_TAB.items():
        a = win[:, :, p1, dy1:dy1 + 4, dx1:dx1 + 4]
        b = a if p2 < 0 else \
            (a + win[:, :, p2, dy2:dy2 + 4, dx2:dx2 + 4] + 1) >> 1
        pred = torch.where(((xf == fx) & (yf == fy))[..., None, None], b,
                           pred)

    # ---- chroma: a 2 x cbh block per luma 4x4 block, eighth-pel; cbh 2
    # at 4:2:0, 4 at 4:2:2, where the vertical MV is in quarter samples
    Hc, Wc = padU_stack.shape[1:]
    cw, ch = w // 2, Hc - 2 * PAD
    cbh = ch // (4 * mb_h)
    cx8 = (px // 2) * 8 + mvx
    cy8 = (py // 2) * 8 + mvy if cbh == 2 else py * 8 + 2 * mvy
    if chroma_dy is not None:
        cy8 = cy8 + chroma_dy.to(I32)[ref_b]
    cxi = torch.clamp(cx8 >> 3, -PAD, cw + PAD - 3)
    cyi = torch.clamp(cy8 >> 3, -PAD, ch + PAD - cbh - 1)
    i3 = torch.arange(3, device=dev)
    iy = torch.arange(cbh + 1, device=dev)
    cidx = (ref_b[..., None, None] * Hc + (cyi + PAD).long()[..., None, None]
            + iy[:, None]) * Wc + (cxi + PAD).long()[..., None, None] + i3
    cwin = torch.stack([padU_stack.reshape(-1)[cidx],
                        padV_stack.reshape(-1)[cidx]], dim=2).to(I32)
    wx = (cx8 & 7)[..., None, None, None]                    # (N,16,1,1,1)
    wy = (cy8 & 7)[..., None, None, None]
    cpred = ((8 - wx) * (8 - wy) * cwin[..., :cbh, :2]
             + wx * (8 - wy) * cwin[..., :cbh, 1:]
             + (8 - wx) * wy * cwin[..., 1:, :2]
             + wx * wy * cwin[..., 1:, 1:] + 32) >> 6     # (N,16,2,cbh,2)
    return pred, cpred


def _weigh(p0, p1, pd, w0, o0, w1, o1, logwd, cmax: int):
    """Spec 8.4.2.3.2 on blocks of either plane: p0 / p1 the list-0 / 1
    predictions (p1 None for a P picture), pd the direction of each block
    (0 list 0, 1 list 1, 2 both), w0 / o0 / w1 / o1 each block's weights
    and offsets, logwd its logWD, all broadcast to p0. One list:
    ((p w + 2^(logWD - 1)) >> logWD) + o (no rounding term at logWD 0);
    both: ((p0 w0 + p1 w1 + 2^logWD) >> (logWD + 1)) + ((o0 + o1 + 1)
    >> 1). Clipped to 0..cmax (before the residual is added)."""
    one = torch.ones_like(logwd)
    half = (one << logwd) >> 1
    out = ((p0 * w0 + half) >> logwd) + o0
    if p1 is not None:
        u1 = ((p1 * w1 + half) >> logwd) + o1
        bi = ((p0 * w0 + p1 * w1 + (one << logwd)) >> (logwd + 1)) \
            + ((o0 + o1 + 1) >> 1)
        out = torch.where(pd == 1, u1, torch.where(pd == 2, bi, out))
    return torch.clamp(out, 0, cmax)


def _weigh_planes(pred, cpred, pred1, cpred1, pd, wp, bd):
    """The weighted luma (N, 16, 4, 4) and chroma (N, 16, 2, cbh, 2)
    predictions. wp = (w0, o0, w1, o1, logwd): the weights and offsets of
    each list (N, 4, 3) per 8x8 and component (Y, Cb, Cr), logwd (N, 2)
    the luma and chroma logWD of each MB; pd (N, 16) per 4x4 block; bd
    the (luma, chroma) bit depths of the clips."""
    w0, o0, w1, o1, logwd = (t.to(I32) for t in wp)
    blk = torch.arange(16, device=pred.device)
    quad = (blk // 8) * 2 + (blk % 4) // 2
    y = [t[:, quad, 0, None, None] for t in (w0, o0, w1, o1)]
    c = [t[:, quad, 1:, None, None] for t in (w0, o0, w1, o1)]
    lum, chrom = pd[..., None, None], pd[..., None, None, None]
    py = _weigh(pred, pred1, lum, *y, logwd[:, 0, None, None, None],
                (1 << bd[0]) - 1)
    pc = _weigh(cpred, cpred1, chrom, *c,
                logwd[:, 1, None, None, None, None], (1 << bd[1]) - 1)
    return py, pc


def _recon(pred, cpred, res_l, res_c, inter_mask, *, mb_w: int, mb_h: int,
           bd=(8, 8)):
    """Prediction + residual, clipped at (1 << bd) - 1, as (Y, U, V)
    planes of ``consts.plane_dtype(bd)``; the MBs outside inter_mask
    zero."""
    n = mb_w * mb_h
    w, h = 16 * mb_w, 16 * mb_h
    dt = plane_dtype(bd)
    mask = inter_mask.to(torch.bool)
    recb = torch.clamp(pred + res_l, 0, (1 << bd[0]) - 1) \
        * mask[:, None, None, None]
    Y = recb.to(dt).reshape(mb_h, mb_w, 4, 4, 4, 4) \
        .permute(0, 2, 4, 1, 3, 5).reshape(h, w)
    # per MB and component a 4 cbh x 8 block: luma block (by, bx) covers
    # chroma rows cbh by.., columns 2 bx..; chroma 4x4 block 2 qy + qx
    cbh = cpred.shape[3]
    ch = 4 * cbh
    cpred = cpred.reshape(n, 4, 4, 2, cbh, 2).permute(0, 3, 1, 4, 2, 5) \
        .reshape(n, 2, ch, 8)
    cres = res_c.reshape(n, 2, cbh, 2, 4, 4).permute(0, 1, 2, 4, 3, 5) \
        .reshape(n, 2, ch, 8)
    rc = torch.clamp(cpred + cres, 0, (1 << bd[1]) - 1) \
        * mask[:, None, None, None]
    UV = rc.to(dt).reshape(mb_h, mb_w, 2, ch, 8) \
        .permute(2, 0, 3, 1, 4).reshape(2, ch * mb_h, w // 2)
    return Y, UV[0], UV[1]


def inter_recon_p(mv, ref_idx, res_l, res_c, planes_stack, padU_stack,
                  padV_stack, inter_mask, *, mb_w: int, mb_h: int,
                  wp=None, bd=(8, 8), chroma_dy=None):
    """Inter reconstruction of every inter MB of a P picture.

    mv (N, 16, 2) quarter-pel per raster 4x4 block; ref_idx (N, 4) list0
    index per 8x8; res_l (N, 16, 4, 4), res_c (N, 2, 2 crows, 4, 4) int32;
    planes_stack (R, 4, H+2P, W+2P), padU_stack / padV_stack
    (R, H/2+2P, W/2+2P) at 4:2:0, (R, H+2P, W/2+2P) at 4:2:2
    (ops/enc.prep_ref of each reference; uint8, or int16 above 8 bits);
    inter_mask (N,) bool; wp None (default prediction) or the explicit
    weighted prediction (w0, o0, w1, o1, logwd) of _weigh_planes (the
    list-1 tables unused); bd the (luma, chroma) bit depths; chroma_dy
    the field picture's chroma offset of each stack entry (_mc_pred) or
    None. Returns (Y, U, V) planes of ``consts.plane_dtype(bd)``, the MBs
    outside inter_mask zero."""
    pred, cpred = _mc_pred(mv, ref_idx, planes_stack, padU_stack,
                           padV_stack, mb_w=mb_w, mb_h=mb_h,
                           chroma_dy=chroma_dy)
    if wp is not None:
        pd = torch.zeros(pred.shape[:2], dtype=I32, device=pred.device)
        pred, cpred = _weigh_planes(pred, cpred, None, None, pd, wp, bd)
    return _recon(pred, cpred, res_l, res_c, inter_mask, mb_w=mb_w,
                  mb_h=mb_h, bd=bd)


def inter_recon_b(mv, mv_l1, ref_idx, ref_idx_l1, pdir, res_l, res_c,
                  planes_stack, padU_stack, padV_stack, inter_mask, *,
                  mb_w: int, mb_h: int, wp=None, bd=(8, 8)):
    """Inter reconstruction of every inter MB of a B picture (defined by
    jm_tpu/decoder/recon.py Reconstructor._recon_inter / _mc_4x4, spec
    8.4.2.3.1): each 4x4 block is predicted from list 0, list 1 or both
    as the pdir of its 8x8 says (0, 1, 2), both lists averaged as
    (p0 + p1 + 1) >> 1 after each list's MC, in luma and in eighth-pel
    chroma (default weights).

    mv / mv_l1 (N, 16, 2); ref_idx / ref_idx_l1 (N, 4) indices into the
    one stack of the picture's references (-1 where the list is unused);
    pdir (N, 4); wp None or the weighted prediction of _weigh_planes
    (explicit or implicit: a table per 8x8 made for its direction); the
    rest as inter_recon_p."""
    p0, c0 = _mc_pred(mv, ref_idx, planes_stack, padU_stack, padV_stack,
                      mb_w=mb_w, mb_h=mb_h)
    p1, c1 = _mc_pred(mv_l1, ref_idx_l1, planes_stack, padU_stack,
                      padV_stack, mb_w=mb_w, mb_h=mb_h)
    blk = torch.arange(16, device=mv.device)
    quad = (blk // 8) * 2 + (blk % 4) // 2
    pd = pdir.to(I32)[:, quad]                                  # (N, 16)
    if wp is not None:
        pred, cpred = _weigh_planes(p0, c0, p1, c1, pd, wp, bd)
        return _recon(pred, cpred, res_l, res_c, inter_mask, mb_w=mb_w,
                      mb_h=mb_h, bd=bd)
    lum, chrom = pd[..., None, None], pd[..., None, None, None]
    pred = torch.where(lum == 1, p1,
                       torch.where(lum == 2, (p0 + p1 + 1) >> 1, p0))
    cpred = torch.where(chrom == 1, c1,
                        torch.where(chrom == 2, (c0 + c1 + 1) >> 1, c0))
    return _recon(pred, cpred, res_l, res_c, inter_mask, mb_w=mb_w,
                  mb_h=mb_h, bd=bd)




def _rnd(x, b):
    """Rounded right shift (x + 2^(b-1)) >> b by a tensor of shifts b."""
    return (x + (torch.ones_like(b) << (b - 1))) >> b


def _sp_requant(PB, lev, qp_per, qs_per, switch, Q, Dqp, Dqs):
    """The SP requantization of 4x4 transforms (spec 8.6.1; jm_tpu
    decoder/recon.py _sp_luma, ldecod block.c itrans_sp): PB the
    transformed prediction, lev the levels in raster order; qp_per /
    qs_per QP / 6 and QS / 6, switch sp_for_switch_flag, Q the quant
    scale at QS, Dqp / Dqs the dequant scales at QP / QS, all broadcast
    to PB. With switch the prediction alone is quantized at QS and the
    levels added; else the prediction plus the levels dequantized at QP
    (times A) is. Returns (the level at QS * Dqs) << qs_per, int64."""
    qbits = 15 + qs_per
    A = on(_SP_A, PB.device)
    il_sw = torch.sign(PB) * _rnd(torch.abs(PB) * Q, qbits) + lev
    base = PB + (((lev * Dqp * A) << qp_per) >> 6)
    il = torch.sign(base) * _rnd(torch.abs(base) * Q, qbits)
    return (torch.where(switch, il_sw, il) * Dqs) << qs_per


def sp_recon(Y, U, V, idx, luma_coef, chroma_dc, chroma_coef, qp, qs,
             switch, *, mb_w: int):
    """The reconstruction of the inter MBs of SP slices (spec 8.6.1), the
    arithmetic of jm_tpu/decoder/recon.py _sp_luma / _sp_chroma (ldecod
    block.c itrans_sp, itrans_sp_cr), batched over the MBs idx (K,)
    int64 of a 4:2:0 8-bit picture. Y, U, V hold the MBs' prediction
    (the inter recon without a residual), which is replaced, in place,
    by: the forward 4x4 of the prediction, requantized at QS with the
    levels (_sp_requant), the chroma DC through the 2x2 Hadamard of the
    prediction's DCs, at the chroma QP of QP and QS without the PPS
    offset (jm_tpu recon.py:726-727), then the inverse transform, the
    rounding and the clip. luma_coef (N, 16, 16), chroma_dc (N, 2, 4),
    chroma_coef (N, 2, 4, 16): the levels as parsed (scan order); qp /
    qs (N,) int; switch (N,) bool. In int64: level * V * A << QP / 6
    overflows int32. Returns (Y, U, V)."""
    dev, i64 = Y.device, torch.int64
    k = idx.numel()
    my, mx = idx // mb_w, idx % mb_w
    zz = on(_SCAN4[False], dev)
    tq, td = on(_SP_Q, dev), on(_SP_D, dev)
    qpv, qsv = qp[idx].to(i64), qs[idx].to(i64)
    sw = switch[idx].to(torch.bool)
    b5 = (slice(None),) + (None,) * 4

    def raster(coef, nb):
        lev = torch.zeros((k, nb, 16), dtype=i64, device=dev)
        lev[..., zz] = coef.to(i64)
        s = 4 if nb == 16 else 2
        return lev.reshape(k, s, s, 4, 4)         # (K, by, bx, 4, 4)

    def mbs(plane, size):
        # the MBs of plane as a (mb_h, mb_w, size, size) view
        return plane.view(-1, size, mb_w, size).permute(0, 2, 1, 3)

    def pred_t(plane, size):
        # the forward transform of the MBs' 4x4 blocks (K, by, bx, 4, 4)
        s = size // 4
        p = mbs(plane, size)[my, mx].to(i64).reshape(k, s, 4, s, 4)
        return T.forward4x4(p.permute(0, 1, 3, 2, 4), i64)

    def write(plane, size, cof):
        rec = torch.clamp((T.inverse4x4(cof, i64) + 32) >> 6, 0, 255)
        mbs(plane, size)[my, mx] = rec.permute(0, 1, 3, 2, 4) \
            .reshape(k, size, size).to(plane.dtype)

    PB = pred_t(Y, 16)
    cof = _sp_requant(PB, raster(luma_coef[idx], 16), (qpv // 6)[b5],
                      (qsv // 6)[b5], sw[b5], tq[qsv % 6][:, None, None],
                      td[qpv % 6][:, None, None], td[qsv % 6][:, None, None])
    write(Y, 16, cof)

    qpc = on(_SP_QPC, dev)[qpv]
    qsc = on(_SP_QPC, dev)[qsv]
    Q, Dp, Ds = tq[qsc % 6], td[qpc % 6], td[qsc % 6]      # (K, 4, 4)
    qb1 = (16 + qsc // 6)[:, None]
    for comp, plane in ((0, U), (1, V)):
        PB = pred_t(plane, 8)
        a, b = PB[:, 0, 0, 0, 0], PB[:, 1, 0, 0, 0]
        c, d = PB[:, 0, 1, 0, 0], PB[:, 1, 1, 0, 0]
        mp1 = torch.stack([a + b + c + d, a - b + c - d, a + b - c - d,
                           a - b - c + d], dim=1)          # (K, 4)
        dcl = chroma_dc[idx, comp].to(i64)
        q00 = Q[:, 0, 0, None]
        il_sw = torch.sign(mp1) * _rnd(torch.abs(mp1) * q00, qb1) + dcl
        bdc = mp1 + (((dcl * Dp[:, 0, 0, None] * 16)
                      << (qpc // 6)[:, None]) >> 5)
        il = torch.sign(bdc) * _rnd(torch.abs(bdc) * q00, qb1)
        m = (torch.where(sw[:, None], il_sw, il) * Ds[:, 0, 0, None]) \
            << (qsc // 6)[:, None]
        cof = _sp_requant(PB, raster(chroma_coef[idx, comp], 4),
                          (qpc // 6)[b5], (qsc // 6)[b5], sw[b5],
                          Q[:, None, None], Dp[:, None, None],
                          Ds[:, None, None])
        m0, m1, m2, m3 = m.unbind(1)
        cof[:, 0, 0, 0, 0] = (m0 + m1 + m2 + m3) >> 1
        cof[:, 0, 1, 0, 0] = (m0 + m1 - m2 - m3) >> 1
        cof[:, 1, 0, 0, 0] = (m0 - m1 + m2 - m3) >> 1
        cof[:, 1, 1, 0, 0] = (m0 - m1 - m2 + m3) >> 1
        write(plane, 8, cof)
    return Y, U, V
