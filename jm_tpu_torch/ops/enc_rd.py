"""Batched trial-encode RD mode decision for the P fast path (twin of
jm_tpu/ops/enc_rd.py: the all-modes tier and the pruned top-2 tier).

Per MB P_Skip and the partition modes (all four, or the two best
SATD-ranked) are trial encoded: MC prediction from the refine windows,
exact transform / quant / recon, SSD, JM coefficient-cost thresholding, exact CAVLC bit lengths
(MB-external nC treated as unavailable), chroma trial per candidate.
J = SSD + lambda_mode * bits picks the winner (lencod/src/md_high.c:38,
md_highfast.c:95 preselection). J is float32 rounded once, as the fused
multiply-add of jm_tpu's compiled program gives it (rd_cost); ties go to
the first candidate (torch.argmin keeps the first minimum).
"""

from __future__ import annotations

import numpy as np
import torch

from . import enc as E
from . import quant as Q
from . import transform as T
from .cavlc import (CBP_INTER_INV, CT_LEN_D, RUN_LEN_D, TZ_DC420_LEN_D,
                    TZ_LEN_D, block_slots, mv_pred_parts, nc_grid,
                    skip_mv_field, ue_len)
from .consts import on

I32 = torch.int32

# qjob index of (mode, quad): the qjob whose parent job serves quad q
# under partition mode m
QJOB_OF = np.zeros((4, 4), np.int64)
for _m in range(4):
    for _q in range(4):
        _j = E.BLK_JOB[_m, (_q // 2) * 8 + (_q % 2) * 2]
        for _k in range(16):
            if E.QJ_PARENT[_k] == _j and E.QJ_QUAD[_k] == _q:
                QJOB_OF[_m, _q] = _k

# raster 4x4 block id of (quad, sub-block), and its inverse
RASTER_OF = np.zeros((4, 4), np.int64)
for _q in range(4):
    for _s in range(4):
        RASTER_OF[_q, _s] = ((_q // 2) * 2 + _s // 2) * 4 \
            + (_q % 2) * 2 + (_s % 2)
QUAD_OF_BLK = np.zeros(16, np.int64)
SUB_OF_BLK = np.zeros(16, np.int64)
for _q in range(4):
    for _s in range(4):
        QUAD_OF_BLK[RASTER_OF[_q, _s]] = _q
        SUB_OF_BLK[RASTER_OF[_q, _s]] = _s
RASTER_FLAT = RASTER_OF.reshape(-1)
INV_RASTER_FLAT = np.argsort(RASTER_FLAT)

# mb_type ue(v) length per P mode + the four ue(0) sub_mb_types of 8x8
MODE_HDR_BITS = np.array([1, 3, 3, 5 + 4], np.int32)

# per (mode, quad): parent job, whether the quad is its job's first (the
# mvd is written once per job), the job's partition slot in the mode
PARENT_OF = np.zeros((4, 4), np.int64)
FIRSTQ = np.zeros((4, 4), np.int32)
PART_OF = np.zeros((4, 4), np.int64)
for _m in range(4):
    _seen = set()
    for _q in range(4):
        _j = int(E.QJ_PARENT[QJOB_OF[_m, _q]])
        PARENT_OF[_m, _q] = _j
        PART_OF[_m, _q] = E.MODE_JOBS[_m].index(_j)
        if _j not in _seen:
            FIRSTQ[_m, _q] = 1
            _seen.add(_j)


def lambda_mode_f(qp: int) -> float:
    """md_high lambda: 0.85 * 2^((qp-12)/3)."""
    return 0.85 * 2.0 ** ((qp - 12) / 3.0)


def rd_cost(dist, bits, lam_f):
    """J = float32(dist) + lam_f * float32(bits), rounded once to float32
    as a fused multiply-add rounds it (XLA contracts this expression on
    the CPU). The product is exact in float64, and so is the sum while
    the addends span at most 53 bits: an MB's SSD is below 2^26 and
    lam_f >= 2^-4 from QP 1 up; one rounding of it is then the fused
    result."""
    return (dist.to(torch.float32).double()
            + lam_f.double() * bits.to(torch.float32).double()).float()


def luma_quad_tq(oq, pred8, qp: int):
    """Trial-encode 8x8 luma quads: oq / pred8 (B, 8, 8) int32. Returns
    (scan (B, 4, 16) after the quad threshold, costq (B,), nnz (B, 4),
    ssd_coded (B,), ssd_zero (B,), rec (B, 8, 8) uint8)."""
    b = oq.shape[0]
    blocks = (oq - pred8).reshape(b, 2, 4, 2, 4).permute(0, 1, 3, 2, 4) \
        .reshape(b, 4, 4, 4)
    wt = T.forward4x4(blocks)
    qpv = torch.full((b, 4), qp, dtype=I32, device=oq.device)
    scan = E.to_scan(Q.quant_4x4(wt, qpv, False))
    costq = E.coeff_cost(scan).sum(dim=1)
    scan = torch.where((costq > 4)[:, None, None], scan, 0)
    r = T.inverse4x4_round(Q.dequant_4x4(E.from_scan(scan), qpv))
    pred_b = pred8.reshape(b, 2, 4, 2, 4).permute(0, 1, 3, 2, 4) \
        .reshape(b, 4, 4, 4)
    rec = torch.clamp(pred_b + r, 0, 255).reshape(b, 2, 2, 4, 4) \
        .permute(0, 1, 3, 2, 4).reshape(b, 8, 8)
    ssd_coded = ((oq - rec) ** 2).sum(dim=(1, 2))
    ssd_zero = ((oq - torch.clamp(pred8, 0, 255)) ** 2).sum(dim=(1, 2))
    nnz = (scan != 0).sum(dim=2).to(I32)
    return scan, costq, nnz, ssd_coded, ssd_zero, rec.to(torch.uint8)


def block_len_parts(scan, max_coeff: int):
    """nC-independent CAVLC length parts of batched blocks (scan (B, L)):
    (total_coeff (B,), trailing_ones (B,), rest (B,)) where rest is the
    sign, level, total_zeros and run_before bits; the caller adds the
    coeff_token length for its nC."""
    dev = scan.device
    B, L = scan.shape
    c = scan.to(I32)
    mask = c != 0
    tc = mask.sum(dim=1)
    rfe = torch.flip(torch.cumsum(torch.flip(mask, [1]).to(I32), dim=1), [1])
    is1 = (torch.abs(c) == 1) & mask
    o0 = ((rfe == 1) & is1).any(dim=1)
    o1 = ((rfe == 2) & is1).any(dim=1)
    o2 = ((rfe == 3) & is1).any(dim=1)
    a0 = o0 & (tc >= 1)
    a1 = a0 & o1 & (tc >= 2)
    a2 = a1 & o2 & (tc >= 3)
    t1 = a0.to(I32) + a1.to(I32) + a2.to(I32)

    hi = (L - 1) - torch.argmax(torch.flip(mask, [1]).to(I32), dim=1)
    tz = hi + 1 - tc
    rest = t1.to(torch.int64)
    tzc = torch.clamp(tz, 0, max_coeff - 1)
    vi = torch.clamp(tc - 1, 0, max_coeff - 2)
    tab = TZ_DC420_LEN_D if max_coeff == 4 else TZ_LEN_D
    tzl = on(tab, dev)[vi, tzc]
    rest = rest + torch.where((tc > 0) & (tc < max_coeff), tzl, 0)

    run_tab = on(RUN_LEN_D, dev)
    sl = torch.where((tc > 10) & (t1 < 3), 1, 0)
    j = torch.zeros(B, dtype=torch.int64, device=dev)
    zl = torch.where(tc > 0, tz, 0)
    prev = hi
    for p in range(L - 1, -1, -1):
        lv = c[:, p]
        nz = mask[:, p]
        lvl_act = nz & (j >= t1)
        lc = torch.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        lc = lc - torch.where((j == t1) & (t1 < 3), 2, 0)
        l0 = torch.where(lc < 14, lc + 1, torch.where(lc < 30, 19, 28))
        pre = lc >> torch.clamp(sl, min=1)
        lN = torch.where(pre < 15, pre + 1 + sl, 28)
        ln = torch.where(sl == 0, l0, lN)
        rest = rest + torch.where(lvl_act, ln, 0)
        sl_next = torch.clamp(sl, min=1)
        sl_next = torch.where((torch.abs(lv) > (3 << (sl_next - 1)))
                              & (sl_next < 6), sl_next + 1, sl_next)
        sl = torch.where(lvl_act, sl_next, sl)
        run = prev - p - 1
        run_act = nz & (j >= 1) & (zl > 0)
        vlc = torch.clamp(torch.clamp(zl, max=7) - 1, 0, 6)
        rl = run_tab[vlc, torch.clamp(run, 0, 14)]
        rest = rest + torch.where(run_act, rl, 0)
        zl = torch.where(run_act, zl - run, zl)
        prev = torch.where(nz, p, prev)
        j = j + nz
    return tc, t1, rest


def ct_len(nc_cat, t1, tc):
    """coeff_token length from nC category (0..2 tables, 3 = 6-bit FLC)."""
    tab = on(CT_LEN_D, nc_cat.device)[torch.clamp(nc_cat, 0, 2), t1, tc]
    return torch.where(nc_cat >= 3, 6, tab)


def nc_cat(nc):
    return torch.where(nc < 2, 0, torch.where(nc < 4, 1,
                                              torch.where(nc < 8, 2, 3)))


def luma_nc_inmb(nnz16):
    """(N, 16) raster nnz -> (N, 16) nC with MB-external neighbours
    unavailable (the batched-RD approximation)."""
    n = nnz16.shape[0]
    return nc_grid(nnz16.reshape(n, 4, 4)).reshape(n, 16)


def chroma_nc_inmb(cnnz):
    """(N, 2, 4) -> (N, 2, 4) in-MB chroma nC (2x2 blocks per comp)."""
    n = cnnz.shape[0]
    return nc_grid(cnnz.reshape(n, 2, 2, 2)).reshape(n, 2, 4)


def chroma_trial(padU, padV, mv_quad, mb_xy, orig_u, orig_v, qpc: int,
                 sr: int):
    """Chroma trial encode of one motion hypothesis per MB."""
    pu, pv = E.mc_chroma_quads(padU, padV, mv_quad, mb_xy, sr)
    dc, ac, cnnz, cbp_c, recU, recV = E.chroma_residual(
        orig_u, orig_v, pu, pv, qpc, False)
    ssd = (((orig_u.to(I32) - recU.to(I32)) ** 2).sum(dim=(1, 2))
           + ((orig_v.to(I32) - recV.to(I32)) ** 2).sum(dim=(1, 2)))
    n = orig_u.shape[0]
    _dv, dl, _do = block_slots(
        dc.reshape(n * 2, 4),
        torch.full((n * 2,), -1, dtype=I32, device=dc.device), 4)
    dc_bits = dl.sum(dim=1).reshape(n, 2).sum(dim=1)
    tc_a, t1_a, rest_a = block_len_parts(ac.reshape(n * 8, 16)[:, 1:], 15)
    ncc = nc_cat(chroma_nc_inmb(cnnz).reshape(n * 8))
    ac_bits = (ct_len(ncc, t1_a, tc_a) + rest_a).reshape(n, 8).sum(dim=1)
    bits = torch.where(cbp_c >= 1, dc_bits, 0) \
        + torch.where(cbp_c >= 2, ac_bits, 0)
    return dict(dc=dc, ac=ac, cnnz=cnnz, cbp_c=cbp_c, recU=recU,
                recV=recV, ssd=ssd, bits=bits)


def _take(arr, idx, dim: int):
    """take_along_axis with the index broadcast over trailing dims."""
    shape = list(arr.shape)
    shape[dim] = idx.shape[dim]
    idx = idx.reshape(*idx.shape, *([1] * (arr.dim() - idx.dim())))
    return torch.gather(arr, dim, idx.expand(shape))


def p_mode_rd_device(planes, padU, padV, win, mv_q, int_mv, pred, orig_q,
                     orig_u, orig_v, mb_xy, qp: int, qpc: int, *,
                     mb_w: int, mb_h: int, sr: int, mode_satd=None,
                     top_modes: int = 4):
    """Per-MB choice among P_Skip and the partition modes by J = SSD +
    lambda_mode * exact bits: all four modes, or with top_modes < 4 and
    mode_satd (the SATD + rate mode costs) the two best SATD-ranked ones
    (twin of enc_rd.p_mode_rd_device)."""
    if top_modes < 4 and mode_satd is not None:
        return p_mode_rd_pruned(planes, padU, padV, win, mv_q, int_mv, pred,
                                orig_q, orig_u, orig_v, mb_xy, qp, qpc,
                                mode_satd, mb_w=mb_w, mb_h=mb_h, sr=sr)
    return p_mode_rd_full(planes, padU, padV, win, mv_q, int_mv, pred,
                          orig_q, orig_u, orig_v, mb_xy, qp, qpc,
                          mb_w=mb_w, mb_h=mb_h, sr=sr)


def _mvd_bits(se, d):
    """se(v) bits of the two components of (..., 2) MV differences."""
    return se[torch.clamp(torch.abs(d[..., 0]), 0, 4095)] \
        + se[torch.clamp(torch.abs(d[..., 1]), 0, 4095)]


def _skip_trial(planes, padU, padV, smv, mb_xy, orig16, orig_u, orig_v,
                sr: int):
    """P_Skip at (N, 2) MVs: (mv_quad, luma pred, chroma preds, SSD)."""
    n = smv.shape[0]
    s4 = smv[:, None, :].expand(n, 4, 2)
    p16 = E.mc_luma_quads(planes, s4, mb_xy, sr)
    ssd_l = ((orig16 - p16) ** 2).sum(dim=(1, 2))
    pu, pv = E.mc_chroma_quads(padU, padV, s4, mb_xy, sr)
    sc = (((orig_u.to(I32) - pu) ** 2).sum(dim=(1, 2))
          + ((orig_v.to(I32) - pv) ** 2).sum(dim=(1, 2)))
    return s4, p16, pu, pv, (ssd_l + sc).to(torch.float32)


def p_mode_rd_full(planes, padU, padV, win, mv_q, int_mv, pred, orig_q,
                   orig_u, orig_v, mb_xy, qp: int, qpc: int, *,
                   mb_w: int, mb_h: int, sr: int):
    """Trial-encode RD over all four partition modes plus P_Skip (twin of
    enc_rd._p_mode_rd_full, the top_modes=4 tier)."""
    n = mb_w * mb_h
    dev = mv_q.device
    lam_f = torch.full((), lambda_mode_f(qp), dtype=torch.float32,
                       device=dev)
    cbp_inv = on(CBP_INTER_INV, dev)
    se = on(E.SE_BITS, dev)
    quad_w = on(E.QUAD_BITS, dev)
    raster = on(RASTER_FLAT, dev)

    # ---- per-qjob luma trials ----------------------------------------
    blk_pred = E.qjob_pred_blocks(win, mv_q, int_mv)          # (N, 16, 8, 8)
    oq = orig_q.to(I32)[:, on(E.QJ_QUAD, dev)]
    scan4, costq, nnz4, ssd_c, ssd_z, rec8 = luma_quad_tq(
        oq.reshape(n * 16, 8, 8), blk_pred.reshape(n * 16, 8, 8), qp)
    scan4 = scan4.reshape(n, 16, 4, 16)
    costq = costq.reshape(n, 16)
    nnz4 = nnz4.reshape(n, 16, 4)
    ssd_c = ssd_c.reshape(n, 16)
    ssd_z = ssd_z.reshape(n, 16)
    rec8 = rec8.reshape(n, 16, 8, 8)
    tc_b, t1_b, rest_b = block_len_parts(scan4.reshape(n * 16 * 4, 16), 16)
    tc_b = tc_b.reshape(n, 16, 4)
    t1_b = t1_b.reshape(n, 16, 4)
    rest_b = rest_b.reshape(n, 16, 4)

    # ---- per-mode luma cost and chroma trial -------------------------
    modes = []
    for m in range(4):
        sel = on(QJOB_OF, dev)[m]
        cq = costq[:, sel]                                    # (N, 4)
        keep_q = cq > 4
        kept = keep_q & (torch.where(keep_q, cq, 0).sum(dim=1) > 5)[:, None]
        luma_ssd = torch.where(kept, ssd_c[:, sel], ssd_z[:, sel]).sum(dim=1)
        nnz_m = torch.where(kept[..., None], nnz4[:, sel], 0)  # (N, 4, 4)
        nnz16 = nnz_m.reshape(n, 16)[:, on(INV_RASTER_FLAT, dev)]
        nc16 = nc_cat(luma_nc_inmb(nnz16))
        ct = ct_len(nc16[:, raster].reshape(n, 4, 4), t1_b[:, sel],
                    tc_b[:, sel])
        bl = (ct + rest_b[:, sel]).sum(dim=2)                 # (N, 4)
        cbp_l = ((nnz_m.sum(dim=2) > 0).to(I32) * quad_w).sum(dim=1)
        jobs = E.MODE_JOBS[m]
        mv_jobs = mv_q[:, jobs[0]:jobs[-1] + 1]               # (N, jobs, 2)
        mvq_m = mv_q[:, on(PARENT_OF, dev)[m]]                # (N, 4, 2)
        modes.append(dict(
            kept=kept, luma_ssd=luma_ssd,
            luma_bits=torch.where(kept, bl, 0).sum(dim=1), cbp_l=cbp_l,
            mvb=_mvd_bits(se, mv_jobs - pred[:, None]).sum(dim=1),
            mv_jobs=mv_jobs, mvq=mvq_m,
            chroma=chroma_trial(padU, padV, mvq_m, mb_xy, orig_u, orig_v,
                                qpc, sr)))

    orig16 = orig_q.to(I32).reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)

    def decide(mvb_by_mode, j_skip):
        js = [j_skip]
        for m, mf in enumerate(modes):
            ch = mf["chroma"]
            cbp_full = mf["cbp_l"] | (ch["cbp_c"] << 4)
            cbp_bits = ue_len(cbp_inv[torch.clamp(cbp_full, 0, 47)])
            dqp_bits = (cbp_full != 0).to(I32)
            bits = (int(MODE_HDR_BITS[m]) + mvb_by_mode[m] + cbp_bits
                    + dqp_bits + mf["luma_bits"] + ch["bits"])
            js.append(rd_cost(mf["luma_ssd"] + ch["ssd"], bits, lam_f))
        jstack = torch.stack(js, dim=1)                       # (N, 5)
        return torch.argmin(jstack, dim=1), jstack

    mvq_modes = torch.stack([mf["mvq"] for mf in modes], dim=1)  # (N,4,4,2)

    # ---- pass 1: approximate (per-MB) predictor rate ------------------
    skip4, _p16, _pu, _pv, ssd_skip = _skip_trial(
        planes, padU, padV, pred, mb_xy, orig16, orig_u, orig_v, sr)
    win_p1, _ = decide([mf["mvb"] for mf in modes], ssd_skip + lam_f)
    best_p1 = torch.clamp(win_p1 - 1, 0, 3)
    mv_quad_p1 = _take(mvq_modes, best_p1[:, None], 1)[:, 0]
    mv_quad_p1 = torch.where((win_p1 == 0)[:, None, None], skip4, mv_quad_p1)
    mode_p1 = torch.where(win_p1 == 0, 0, best_p1)

    # ---- pass 2: exact median predictors from the pass-1 field --------
    mv4_p1 = mv_quad_p1[:, on(E.BLK_QUAD, dev)]
    allpred = mv_pred_parts(mv4_p1, mode_p1, mb_w, mb_h,
                            all_modes=True)                   # (N, 4m, 4p, 2)
    mvb_p2 = [_mvd_bits(se, mf["mv_jobs"]
                        - allpred[:, m, :mf["mv_jobs"].shape[1]]).sum(dim=1)
              for m, mf in enumerate(modes)]
    skip4, pred16_skip, pu_s, pv_s, ssd_skip2 = _skip_trial(
        planes, padU, padV, skip_mv_field(mv4_p1, mb_w, mb_h), mb_xy,
        orig16, orig_u, orig_v, sr)
    win_i, jstack = decide(mvb_p2, ssd_skip2)
    is_skip = win_i == 0
    best_m = torch.clamp(win_i - 1, 0, 3)

    # ---- gather final fields (winner mode) ----------------------------
    def take_mode(stack):
        """(N, 4 modes, ...) -> (N, ...) at the winning mode."""
        return _take(stack, best_m[:, None], 1)[:, 0]

    sel_q = on(QJOB_OF, dev)[best_m]                          # (N, 4)
    kept_w = take_mode(torch.stack([mf["kept"] for mf in modes], dim=1)) \
        & ~is_skip[:, None]
    scan_q = torch.where(kept_w[..., None, None], _take(scan4, sel_q, 1), 0)
    nnz_q = torch.where(kept_w[..., None], _take(nnz4, sel_q, 1), 0)
    rec_q = torch.where(
        kept_w[..., None, None], _take(rec8, sel_q, 1),
        torch.clamp(_take(blk_pred, sel_q, 1), 0, 255).to(torch.uint8))
    skip_rec = pred16_skip.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 4, 8, 8).to(torch.uint8)
    rec_q = torch.where(is_skip[:, None, None, None], skip_rec, rec_q)

    qb = on(QUAD_OF_BLK, dev)
    sb = on(SUB_OF_BLK, dev)
    recY = rec_q.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)

    def ch_sel(key, when_skip=None):
        v = take_mode(torch.stack([mf["chroma"][key] for mf in modes],
                                  dim=1))
        z = torch.zeros_like(v) if when_skip is None else when_skip
        return torch.where(is_skip.reshape(n, *([1] * (v.dim() - 1))), z, v)

    cbp_l = ((nnz_q.sum(dim=2) > 0).to(I32) * quad_w).sum(dim=1)
    mv_quad = torch.where(is_skip[:, None, None], skip4, take_mode(mvq_modes))
    return dict(inter_mode=torch.where(is_skip, 0, best_m).to(I32),
                mv_quad=mv_quad.to(I32),
                luma_scan=scan_q[:, qb, sb], luma_nnz=nnz_q[:, qb, sb],
                cbp=(ch_sel("cbp_c") << 4) | cbp_l,
                chroma_dc=ch_sel("dc"), chroma_scan=ch_sel("ac"),
                chroma_nnz=ch_sel("cnnz"), recY_mbs=recY,
                recU_mbs=ch_sel("recU",
                                torch.clamp(pu_s, 0, 255).to(torch.uint8)),
                recV_mbs=ch_sel("recV",
                                torch.clamp(pv_s, 0, 255).to(torch.uint8)),
                j_win=jstack.min(dim=1).values)


def p_mode_rd_pruned(planes, padU, padV, win, mv_q, int_mv, pred, orig_q,
                     orig_u, orig_v, mb_xy, qp: int, qpc: int, mode_satd,
                     *, mb_w: int, mb_h: int, sr: int):
    """Trial-encode RD over the top-2 SATD-ranked partition modes plus
    P_Skip (twin of enc_rd._p_mode_rd_pruned)."""
    n = mb_w * mb_h
    ns = 2
    dev = mv_q.device
    lam_f = torch.full((), lambda_mode_f(qp), dtype=torch.float32,
                       device=dev)
    cbp_inv = on(CBP_INTER_INV, dev)
    se = on(E.SE_BITS, dev)
    blk_quad = on(E.BLK_QUAD, dev)

    # ---- candidate modes by SATD + rate cost --------------------------
    m1 = torch.argmin(mode_satd, dim=1)
    masked = torch.where(torch.arange(4, device=dev)[None] == m1[:, None],
                         float("inf"),
                         mode_satd.to(torch.float32))
    m2 = torch.argmin(masked, dim=1)
    cand = torch.stack([m1, m2], dim=1)                      # (N, 2)

    sel_qjob = on(QJOB_OF, dev)[cand]                        # (N, 2, 4)
    parent = on(PARENT_OF, dev)[cand]
    firstq = on(FIRSTQ, dev)[cand]
    partof = on(PART_OF, dev)[cand]
    hdr_bits = on(MODE_HDR_BITS, dev)[cand]                  # (N, 2)
    flat_sel = sel_qjob.reshape(n, ns * 4)                   # (N, 8)

    # ---- trial inputs at the surviving qjobs ---------------------------
    blk_all = E.qjob_pred_blocks(win, mv_q, int_mv)          # (N, 16, 8, 8)
    blk_pred = _take(blk_all, flat_sel, 1).reshape(n * ns * 4, 8, 8)
    oq_sub = orig_q.to(I32)[torch.arange(n, device=dev)[:, None],
                            on(E.QJ_QUAD, dev)[flat_sel]]    # (N, 8, 8, 8)
    mv_sel = _take(mv_q, parent.reshape(n, ns * 4), 1) \
        .reshape(n, ns, 4, 2)                                # (N, 2, 4, 2)

    scan4, costq, nnz4, ssd_c, ssd_z, rec8 = luma_quad_tq(
        oq_sub.reshape(n * ns * 4, 8, 8), blk_pred, qp)
    scan4 = scan4.reshape(n, ns, 4, 4, 16)
    costq = costq.reshape(n, ns, 4)
    nnz4 = nnz4.reshape(n, ns, 4, 4)
    ssd_c = ssd_c.reshape(n, ns, 4)
    ssd_z = ssd_z.reshape(n, ns, 4)
    rec8 = rec8.reshape(n, ns, 4, 8, 8)
    tc_b, t1_b, rest_b = block_len_parts(
        scan4.reshape(n * ns * 4 * 4, 16), 16)
    tc_b = tc_b.reshape(n, ns, 4, 4)
    t1_b = t1_b.reshape(n, ns, 4, 4)
    rest_b = rest_b.reshape(n, ns, 4, 4)

    # ---- per-slot luma cost ------------------------------------------
    keep_q = costq > 4
    total = torch.where(keep_q, costq, 0).sum(dim=2)         # (N, 2)
    kept = keep_q & (total > 5)[..., None]                   # (N, 2, 4)
    luma_ssd = torch.where(kept, ssd_c, ssd_z).sum(dim=2)    # (N, 2)
    nnz_m = torch.where(kept[..., None], nnz4, 0)            # (N, 2, 4, 4)
    nnz16 = nnz_m.reshape(n, ns, 16)[..., on(INV_RASTER_FLAT, dev)]
    nc16 = nc_cat(luma_nc_inmb(nnz16.reshape(n * ns, 16))).reshape(n, ns, 16)
    ct = ct_len(nc16[:, :, on(RASTER_FLAT, dev)].reshape(n, ns, 4, 4),
                t1_b, tc_b)
    bl = (ct + rest_b).sum(dim=3)                            # (N, 2, 4)
    luma_bits = torch.where(kept, bl, 0).sum(dim=2)          # (N, 2)
    quad_w = on(E.QUAD_BITS, dev)
    cbp_l = ((nnz_m.sum(dim=3) > 0).to(I32) * quad_w).sum(dim=2)

    # ---- per-slot chroma trials --------------------------------------
    chroma = [chroma_trial(padU, padV, mv_sel[:, s], mb_xy, orig_u, orig_v,
                           qpc, sr) for s in range(ns)]

    orig16 = orig_q.to(I32).reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)

    def skip_trial(smv):
        return _skip_trial(planes, padU, padV, smv, mb_xy, orig16, orig_u,
                           orig_v, sr)

    def mvb_of(predq):
        """predq (N, 2, 4, 2): predictor per slot per quad."""
        return (firstq * _mvd_bits(se, mv_sel - predq)).sum(dim=2)  # (N, 2)

    def decide(mvb, j_skip):
        js = [j_skip]
        for s in range(ns):
            ch = chroma[s]
            cbp_full = cbp_l[:, s] | (ch["cbp_c"] << 4)
            cbp_bits = ue_len(cbp_inv[torch.clamp(cbp_full, 0, 47)])
            dqp_bits = (cbp_full != 0).to(I32)
            bits = (hdr_bits[:, s] + mvb[:, s] + cbp_bits + dqp_bits
                    + luma_bits[:, s] + ch["bits"])
            js.append(rd_cost(luma_ssd[:, s] + ch["ssd"], bits, lam_f))
        jstack = torch.stack(js, dim=1)                      # (N, 3)
        return torch.argmin(jstack, dim=1), jstack

    # ---- pass 1: approximate (per-MB) predictor rate ------------------
    skip4, pred16_skip, pu_s, pv_s, ssd_skip = skip_trial(pred)
    win_p1, _ = decide(mvb_of(pred[:, None, None, :].expand(n, ns, 4, 2)),
                       ssd_skip + lam_f)
    slot_p1 = torch.clamp(win_p1 - 1, 0, ns - 1)
    mode_p1 = _take(cand, slot_p1[:, None], 1)[:, 0]
    mv_quad_p1 = _take(mv_sel, slot_p1[:, None], 1)[:, 0]
    mv_quad_p1 = torch.where((win_p1 == 0)[:, None, None], skip4, mv_quad_p1)
    mode_p1 = torch.where(win_p1 == 0, 0, mode_p1)

    # ---- pass 2: exact median predictors from the pass-1 field --------
    mv4_p1 = mv_quad_p1[:, blk_quad]
    allpred = mv_pred_parts(mv4_p1, mode_p1, mb_w, mb_h,
                            all_modes=True)                  # (N, 4m, 4p, 2)
    allpred_s = _take(allpred, cand, 1)                      # (N, 2, 4p, 2)
    predq = _take(allpred_s, partof, 2)                      # (N, 2, 4q, 2)
    smv_exact = skip_mv_field(mv4_p1, mb_w, mb_h)
    skip4, pred16_skip, pu_s, pv_s, ssd_skip2 = skip_trial(smv_exact)
    win_i, jstack = decide(mvb_of(predq), ssd_skip2)
    is_skip = win_i == 0
    best_slot = torch.clamp(win_i - 1, 0, ns - 1)
    best_m = _take(cand, best_slot[:, None], 1)[:, 0]

    # ---- gather final fields (winner slot) ----------------------------
    def take_slot(arr):
        return _take(arr, best_slot[:, None], 1)[:, 0]

    kept_w = take_slot(kept) & ~is_skip[:, None]             # (N, 4)
    scan_q = torch.where(kept_w[..., None, None], take_slot(scan4), 0)
    nnz_q = torch.where(kept_w[..., None], take_slot(nnz4), 0)
    rec_q = torch.where(
        kept_w[..., None, None], take_slot(rec8),
        torch.clamp(take_slot(blk_pred.reshape(n, ns, 4, 8, 8)),
                    0, 255).to(torch.uint8))
    skip_rec = pred16_skip.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 4, 8, 8).to(torch.uint8)
    rec_q = torch.where(is_skip[:, None, None, None], skip_rec, rec_q)

    qb = on(QUAD_OF_BLK, dev)
    sb = on(SUB_OF_BLK, dev)
    scan16 = scan_q[:, qb, sb]                               # (N, 16, 16)
    nnz16f = nnz_q[:, qb, sb]
    cbp_lw = ((nnz_q.sum(dim=2) > 0).to(I32) * quad_w).sum(dim=1)
    recY = rec_q.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)

    def ch_sel(key, when_skip=None):
        outs = torch.stack([chroma[s][key] for s in range(ns)], dim=1)
        v = take_slot(outs)
        z = torch.zeros_like(v) if when_skip is None else when_skip
        return torch.where(is_skip.reshape(n, *([1] * (v.dim() - 1))), z, v)

    dc_f = ch_sel("dc")
    ac_f = ch_sel("ac")
    cnnz_f = ch_sel("cnnz")
    cbp_c_f = ch_sel("cbp_c")
    recU_f = ch_sel("recU", torch.clamp(pu_s, 0, 255).to(torch.uint8))
    recV_f = ch_sel("recV", torch.clamp(pv_s, 0, 255).to(torch.uint8))

    mv_quad = take_slot(mv_sel)
    mv_quad = torch.where(is_skip[:, None, None], skip4, mv_quad)
    inter_mode = torch.where(is_skip, 0, best_m)
    return dict(inter_mode=inter_mode.to(I32), mv_quad=mv_quad.to(I32),
                luma_scan=scan16, luma_nnz=nnz16f,
                cbp=(cbp_c_f << 4) | cbp_lw,
                chroma_dc=dc_f, chroma_scan=ac_f, chroma_nnz=cnnz_f,
                recY_mbs=recY, recU_mbs=recU_f, recV_mbs=recV_f,
                j_win=jstack.min(dim=1).values)
