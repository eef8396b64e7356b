"""CAVLC slice-data packing on tensors (spec 9.2 + 7.3.5 write side),
twin of jm_tpu/ops/cavlc_jax.py.

Every syntax element of every macroblock becomes a (codeword, bit
length) slot in parallel; variable-length concatenation runs in three
batched stages: slots -> fixed per-block word buffers (fold_slots), per
MB pieces with exact lengths (header, 16 luma, 2 chroma DC, 8 chroma AC;
skipped or cbp-gated blocks are empty), and one gather-based assembly of
the output words (assemble). Bit-exact against the host MBWriter
(encoder/syntax.py).

32-bit words are carried as int64 holding values in [0, 2^32): torch has
no uint32 arithmetic on the CPU. Every shift that could carry bits past
bit 31 is masked with 0xFFFFFFFF, which reproduces uint32 wrap-around;
right shifts of non-negative int64 are logical. Conversion to
big-endian uint32 bytes happens only at the host boundary.

Scope: P slices, all-inter (modes 0-3 with 8x8 sub-macroblocks), one
reference, 4:2:0, one slice, fixed QP.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.cavlc_tables import (_CT_COD, _CT_DC_COD, _CT_DC_LEN, _CT_LEN,
                                   _RUN_COD, _RUN_LEN, _TZ_COD, _TZ_DC_COD,
                                   _TZ_DC_LEN, _TZ_LEN)
from ..common.picture import CBP_MAP_CHROMA
from ..common.predict_ctx import CODE2RASTER
from .consts import on

I32 = torch.int32
I64 = torch.int64
MASK32 = 0xFFFFFFFF


def _dense(ragged, shape):
    out = np.zeros(shape, np.int32)

    def fill(dst, src):
        if isinstance(src[0], (list, tuple)):
            for i, row in enumerate(src):
                fill(dst[i], row)
        else:
            dst[:len(src)] = src
    fill(out, ragged)
    return out


# coeff_token tables: cat 0..2 = nc<2/<4/<8; 3 = chroma DC 4:2:0 (nc=-1);
# 4 = chroma DC 4:2:2 (nc=-2). nc>=8 is a 6-bit FLC.
CT_LEN_D = np.zeros((5, 4, 17), np.int32)
CT_COD_D = np.zeros((5, 4, 17), np.int32)
CT_LEN_D[:3] = _dense(_CT_LEN, (3, 4, 17))
CT_COD_D[:3] = _dense(_CT_COD, (3, 4, 17))
CT_LEN_D[3:, :, :9] = _dense(_CT_DC_LEN, (2, 4, 9))
CT_COD_D[3:, :, :9] = _dense(_CT_DC_COD, (2, 4, 9))

TZ_LEN_D = _dense(_TZ_LEN, (15, 16))
TZ_COD_D = _dense(_TZ_COD, (15, 16))
TZ_DC420_LEN_D = _dense(_TZ_DC_LEN[0], (3, 4))
TZ_DC420_COD_D = _dense(_TZ_DC_COD[0], (3, 4))
RUN_LEN_D = _dense(_RUN_LEN, (7, 15))
RUN_COD_D = _dense(_RUN_COD, (7, 15))

# cbp -> inter codeNum (Table 9-4 inverse, chroma present)
CBP_INTER_INV = np.zeros(48, np.int32)
for _i, (_cbp_intra, _cbp_inter) in enumerate(CBP_MAP_CHROMA):
    CBP_INTER_INV[int(_cbp_inter)] = _i

# first 4x4 block of each partition of P modes 0..3, and the counts
FIRST_BLK = np.array([[0, 0, 0, 0], [0, 8, 0, 0], [0, 2, 0, 0],
                      [0, 2, 8, 10]], np.int64)
N_PARTS = np.array([1, 2, 2, 4], np.int64)

# luma write order: 8x8-major, 4x4-minor -> raster block id
WRITE_ORDER = np.asarray(CODE2RASTER, np.int64)

BLOCK_WORDS = 9                      # 288 bits per coded block buffer
HEADER_WORDS = 9                     # 288 bits > worst-case MB header
PIECES_PER_MB = 27                   # header + 16 luma + 2 dc + 8 ac


def bitlen(v):
    """floor(log2(v)) + 1 for v >= 1, elementwise (v < 2^30)."""
    r = torch.zeros_like(v)
    x = v
    for s in (16, 8, 4, 2, 1):
        hit = x >= (1 << s)
        r = r + torch.where(hit, s, 0)
        x = torch.where(hit, x >> s, x)
    return r + 1


def ue_len(v):
    """ue(v) bit length; the codeword value is v + 1 in that many bits."""
    return 2 * bitlen(v + 1) - 1


def se_to_ue(v):
    """se(v) -> ue codeNum (spec 9.1.1)."""
    return torch.where(v > 0, 2 * v - 1, -2 * v)


# ---------------------------------------------------------------------------
# per-block CAVLC slots
# ---------------------------------------------------------------------------

def block_slots(coeffs, nc, max_coeff: int):
    """CAVLC-encode batched residual blocks into syntax-element slots.

    coeffs (B, L) scan order, L = max_coeff; nc (B,) (>= 0 luma / chroma
    AC context, -1 chroma DC 4:2:0). Returns (vals (B, S) int64 in
    [0, 2^32), lens (B, S) int64, ovf (B,) bool). Slot order: coeff_token,
    trailing-one signs, one level slot per scan position (high to low),
    total_zeros, one run_before slot per position; S = 2 + 2 L."""
    B, L = coeffs.shape
    if L != max_coeff:
        raise ValueError(f"block length {L} != max_coeff {max_coeff}")
    dev = coeffs.device
    c = coeffs.to(I64)
    nc = nc.to(I64)
    mask = c != 0
    tc = mask.sum(dim=1)

    rfe = torch.flip(torch.cumsum(torch.flip(mask, [1]).to(I64), dim=1), [1])
    is1 = (torch.abs(c) == 1) & mask
    neg = (c < 0) & mask
    o = [((rfe == j + 1) & is1).any(dim=1) for j in range(3)]
    s_j = [((rfe == j + 1) & neg).any(dim=1).to(I64) for j in range(3)]
    a0 = o[0] & (tc >= 1)
    a1 = a0 & o[1] & (tc >= 2)
    a2 = a1 & o[2] & (tc >= 3)
    t1 = a0.to(I64) + a1.to(I64) + a2.to(I64)

    hi = (L - 1) - torch.argmax(torch.flip(mask, [1]).to(I32), dim=1)
    tz = hi + 1 - tc

    vals = []
    lens = []
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)

    # coeff_token
    cat = torch.where(nc < -1, 4, torch.where(nc < 0, 3, torch.where(
        nc < 2, 0, torch.where(nc < 4, 1, 2))))
    ctl = on(CT_LEN_D, dev)[cat, t1, tc]
    ctv = on(CT_COD_D, dev)[cat, t1, tc]
    flc_v = torch.where(tc == 0, 3, ((tc - 1) << 2) | t1)
    is_flc = nc >= 8
    vals.append(torch.where(is_flc, flc_v, ctv.to(I64)))
    lens.append(torch.where(is_flc, 6, ctl.to(I64)))

    # trailing-one signs (one combined slot, high frequency first)
    t1v = torch.zeros(B, dtype=I64, device=dev)
    for j in range(3):
        t1v = torch.where(t1 > j, (t1v << 1) | s_j[j], t1v)
    vals.append(t1v)
    lens.append(t1)

    sl = torch.where((tc > 10) & (t1 < 3), 1, 0)
    j = torch.zeros(B, dtype=I64, device=dev)
    zl = torch.where(tc > 0, tz, 0)
    prev = hi
    run_vals = []
    run_lens = []
    run_len_t = on(RUN_LEN_D, dev)
    run_cod_t = on(RUN_COD_D, dev)
    for p in range(L - 1, -1, -1):
        lv = c[:, p]
        nz = mask[:, p]
        active = nz & (j >= t1)
        lc = torch.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        lc = lc - torch.where((j == t1) & (t1 < 3), 2, 0)
        # suffix_length == 0
        v0 = torch.where(lc < 14, 1, torch.where(
            lc < 30, (1 << 4) | (lc - 14),
            (1 << 12) | torch.clamp(lc - 30, 0, 4095)))
        l0 = torch.where(lc < 14, lc + 1, torch.where(lc < 30, 19, 28))
        o0 = lc >= 30 + 4096
        # suffix_length > 0
        s1 = torch.clamp(sl, min=1)
        pre = lc >> s1
        sfx = lc & ((1 << s1) - 1)
        esc = lc - (15 << s1)
        vN = torch.where(pre < 15, (1 << s1) | sfx,
                         (1 << 12) | torch.clamp(esc, 0, 4095))
        lN = torch.where(pre < 15, pre + 1 + sl, 28)
        oN = (pre >= 15) & (esc >= 4096)
        v = torch.where(sl == 0, v0, vN)
        ln = torch.where(sl == 0, l0, lN)
        ob = torch.where(sl == 0, o0, oN)
        vals.append(torch.where(active, v, 0))
        lens.append(torch.where(active, ln, 0))
        ovf = ovf | (active & ob)
        sl_next = torch.where((torch.abs(lv) > (3 << (s1 - 1))) & (s1 < 6),
                              s1 + 1, s1)
        sl = torch.where(active, sl_next, sl)
        if p < L - 1:
            run = prev - p - 1
            run_act = nz & (j >= 1) & (zl > 0)
            vlc = torch.clamp(torch.clamp(zl, max=7) - 1, 0, 6)
            runc = torch.clamp(run, 0, 14)
            run_lens.append(torch.where(run_act, run_len_t[vlc, runc].to(I64), 0))
            run_vals.append(torch.where(run_act, run_cod_t[vlc, runc].to(I64), 0))
            zl = torch.where(run_act, zl - run, zl)
        prev = torch.where(nz, p, prev)
        j = j + nz.to(I64)

    # total_zeros (between the level slots and the run slots)
    tzc = torch.clamp(tz, 0, max_coeff - 1)
    vi = torch.clamp(tc - 1, 0, max_coeff - 2)
    if max_coeff == 4:
        tzl = on(TZ_DC420_LEN_D, dev)[vi, tzc]
        tzv = on(TZ_DC420_COD_D, dev)[vi, tzc]
    else:
        tzl = on(TZ_LEN_D, dev)[vi, tzc]
        tzv = on(TZ_COD_D, dev)[vi, tzc]
    tz_on = (tc > 0) & (tc < max_coeff)
    vals.append(torch.where(tz_on, tzv.to(I64), 0))
    lens.append(torch.where(tz_on, tzl.to(I64), 0))
    vals.extend(run_vals)
    lens.extend(run_lens)
    return (torch.stack(vals, dim=1) & MASK32, torch.stack(lens, dim=1), ovf)


# ---------------------------------------------------------------------------
# slot fold -> fixed word buffers
# ---------------------------------------------------------------------------

def fold_slots(vals, lens, n_words: int):
    """OR each slot into a (B, n_words) big-endian 32-bit word buffer at
    its running bit position. Returns (words int64, total_bits)."""
    B, S = vals.shape
    dev = vals.device
    lens = lens.to(I64)
    pos = torch.cat([torch.zeros((B, 1), dtype=I64, device=dev),
                     torch.cumsum(lens, dim=1)], dim=1)
    words = torch.zeros((B, n_words), dtype=I64, device=dev)
    widx = torch.arange(n_words, device=dev)[None, :]
    for s in range(S):
        v = vals[:, s]
        ln = lens[:, s]
        p = pos[:, s]
        d = p >> 5
        r = p & 31
        sh_hi = 32 - r - ln                      # may be negative
        hi = torch.where(sh_hi >= 0,
                         (v << torch.clamp(sh_hi, 0, 31)) & MASK32,
                         v >> torch.clamp(-sh_hi, 0, 31))
        lo = torch.where(sh_hi < 0,
                         (v << torch.clamp(64 - r - ln, 0, 31)) & MASK32, 0)
        hi = torch.where(ln > 0, hi, 0)
        lo = torch.where(ln > 0, lo, 0)
        words = words | torch.where(widx == d[:, None], hi[:, None], 0)
        words = words | torch.where(widx == d[:, None] + 1, lo[:, None], 0)
    return words, pos[:, -1]


# ---------------------------------------------------------------------------
# exact MV predictor field (spec 8.4.1.3, all-inter single-ref fast path)
# ---------------------------------------------------------------------------

def median3(a, b, c):
    return torch.minimum(torch.maximum(torch.minimum(a, b), c),
                         torch.maximum(a, b))


def mv_pred_parts(mv4, inter_mode, mb_w: int, mb_h: int,
                  all_modes: bool = False):
    """Exact median MV predictors of every partition of every MB given
    the committed all-inter / ref-0 / single-slice motion field.

    mv4 (N, 16, 2); inter_mode (N,). Returns (N, 4, 2): the predictor of
    partition p of the MB's coded mode (unused partitions 0), or with
    all_modes (N, 4 modes, 4 parts, 2): what each partition of each
    candidate mode would see."""
    n = mb_w * mb_h
    dev = mv4.device
    mvg = mv4.to(I32).reshape(mb_h, mb_w, 4, 4, 2).permute(0, 2, 1, 3, 4) \
        .reshape(4 * mb_h, 4 * mb_w, 2)
    ar = torch.arange(n, device=dev)
    mbx = (ar % mb_w).reshape(mb_h, mb_w)
    mby = (ar // mb_w).reshape(mb_h, mb_w)
    H, W = 4 * mb_h, 4 * mb_w
    PARTS = {0: [(0, 0, 4, 4)],
             1: [(0, 0, 4, 2), (0, 2, 4, 2)],
             2: [(0, 0, 2, 4), (2, 0, 2, 4)],
             3: [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)]}

    def nbr(bx, by):
        """Availability + MV of the 4x4 block at MB-relative (bx, by);
        blocks right of the current MB within its rows are later in
        decode order, hence unavailable."""
        gx = mbx * 4 + bx
        gy = mby * 4 + by
        avail = (gx >= 0) & (gy >= 0) & (gx < W) & (gy < H)
        avail = avail & ~((gy >= mby * 4) & (gx >= mbx * 4 + 4))
        v = mvg[torch.clamp(gy, 0, H - 1), torch.clamp(gx, 0, W - 1)]
        return avail, torch.where(avail[..., None], v, 0)

    preds = torch.zeros((mb_h, mb_w, 4, 2), dtype=I32, device=dev)
    allp = torch.zeros((mb_h, mb_w, 4, 4, 2), dtype=I32, device=dev)
    mode = inter_mode.reshape(mb_h, mb_w)
    for m, parts in PARTS.items():
        sel_m = mode == m
        for pi, (bx, by, bw, bh) in enumerate(parts):
            ha, mva = nbr(bx - 1, by)
            hb, mvb = nbr(bx, by - 1)
            hc, mvc = nbr(bx + bw, by - 1)
            hd, mvd_ = nbr(bx - 1, by - 1)
            mvc = torch.where(hc[..., None], mvc, mvd_)
            hce = hc | hd
            cnt = ha.to(I32) + hb.to(I32) + hce.to(I32)
            only_a = ha & ~hb & ~hce
            ea = torch.where(ha[..., None], mva, 0)
            eb = torch.where(hb[..., None], mvb, 0)
            ec = torch.where(hce[..., None], mvc, 0)
            p = torch.where((only_a | (cnt == 1))[..., None], ea + eb + ec,
                            median3(ea, eb, ec))
            p = torch.where(only_a[..., None], mva, p)
            # directional predictors of 16x8 / 8x16 partitions
            if (bw, bh) == (4, 2):
                p = torch.where((hb if by == 0 else ha)[..., None],
                                mvb if by == 0 else mva, p)
            elif (bw, bh) == (2, 4):
                p = torch.where((ha if bx == 0 else hce)[..., None],
                                mva if bx == 0 else mvc, p)
            preds[:, :, pi] = torch.where(sel_m[..., None], p,
                                          preds[:, :, pi])
            if all_modes:
                allp[:, :, m, pi] = p
    if all_modes:
        return allp.reshape(n, 4, 4, 2)
    return preds.reshape(n, 4, 2)


def _skip_pred(mv4, mb_w: int, mb_h: int):
    """(P_Skip MV (mh, mw, 2), mv (mh, mw, 16, 2)) per spec 8.4.1.1."""
    mw, mh = mb_w, mb_h
    dev = mv4.device
    mv = mv4.to(I32).reshape(mh, mw, 16, 2)
    mva = torch.cat([torch.zeros((mh, 1, 2), dtype=I32, device=dev),
                     mv[:, :-1, 3]], dim=1)
    mvb = torch.cat([torch.zeros((1, mw, 2), dtype=I32, device=dev),
                     mv[:-1, :, 12]], dim=0)
    mvc = torch.zeros((mh, mw, 2), dtype=I32, device=dev)
    mvd_ = torch.zeros((mh, mw, 2), dtype=I32, device=dev)
    if mh > 1 and mw > 1:
        mvc[1:, :-1] = mv[:-1, 1:, 12]
        mvd_[1:, 1:] = mv[:-1, :-1, 15]
    ry = torch.arange(mh, device=dev)[:, None]
    rx = torch.arange(mw, device=dev)[None, :]
    has_a = (rx > 0).expand(mh, mw)
    has_b = (ry > 0).expand(mh, mw)
    has_c = (ry > 0) & (rx < mw - 1)
    has_d = (ry > 0) & (rx > 0)
    mvc = torch.where(has_c[..., None], mvc, mvd_)
    has_c_eff = has_c | has_d
    cnt = has_a.to(I32) + has_b.to(I32) + has_c_eff.to(I32)
    mva_e = torch.where(has_a[..., None], mva, 0)
    mvb_e = torch.where(has_b[..., None], mvb, 0)
    mvc_e = torch.where(has_c_eff[..., None], mvc, 0)
    pred = torch.where((cnt == 1)[..., None], mva_e + mvb_e + mvc_e,
                       median3(mva_e, mvb_e, mvc_e))
    a_zero = ~has_a | (mva == 0).all(-1)
    b_zero = ~has_b | (mvb == 0).all(-1)
    return torch.where((a_zero | b_zero)[..., None], 0, pred), mv


def skip_mv_field(mv4, mb_w: int, mb_h: int):
    """The exact P_Skip motion vector of every MB. (N, 2) int32."""
    return _skip_pred(mv4, mb_w, mb_h)[0].reshape(mb_w * mb_h, 2)


def skip_field(inter_mode, cbp, mv4, mb_w: int, mb_h: int):
    """P_Skip flags (spec 8.4.1.1): 16x16, no coefficients and the MV
    equal to the skip predictor. (N,) bool."""
    skip_mv, mv = _skip_pred(mv4, mb_w, mb_h)
    cand = ((cbp == 0) & (inter_mode == 0)).reshape(mb_h, mb_w)
    eq = (mv[:, :, 0] == skip_mv).all(-1)
    return (cand & eq).reshape(-1)


# ---------------------------------------------------------------------------
# nC context fields
# ---------------------------------------------------------------------------

def nc_grid(g):
    """nC (spec 9.2.1) of every block of (..., H, W) nnz grids: the
    rounded mean of the left and top counts, blocks outside a grid
    unavailable."""
    na = torch.cat([torch.zeros_like(g[..., :1]), g[..., :-1]], dim=-1)
    nb = torch.cat([torch.zeros_like(g[..., :1, :]), g[..., :-1, :]], dim=-2)
    ha = torch.arange(g.shape[-1], device=g.device) > 0
    hb = (torch.arange(g.shape[-2], device=g.device) > 0)[:, None]
    return torch.where(ha & hb, (na + nb + 1) >> 1,
                       torch.where(ha, na, torch.where(hb, nb, 0)))


def nc_luma_field(luma_nnz, mb_w: int, mb_h: int):
    """(N, 16) -> (N, 16) nC per raster 4x4 luma block."""
    g = luma_nnz.to(I32).reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3) \
        .reshape(4 * mb_h, 4 * mb_w)
    return nc_grid(g).reshape(mb_h, 4, mb_w, 4).permute(0, 2, 1, 3) \
        .reshape(mb_h * mb_w, 16)


def nc_chroma_field(chroma_nnz, mb_w: int, mb_h: int):
    """(N, 2, 4) -> (N, 2, 4) nC per chroma 4x4 block (4:2:0)."""
    out = []
    for comp in range(2):
        g = chroma_nnz[:, comp].to(I32).reshape(mb_h, mb_w, 2, 2) \
            .permute(0, 2, 1, 3).reshape(2 * mb_h, 2 * mb_w)
        out.append(nc_grid(g).reshape(mb_h, 2, mb_w, 2).permute(0, 2, 1, 3)
                   .reshape(mb_h * mb_w, 4))
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# MB header slots
# ---------------------------------------------------------------------------

def header_slots(skip, inter_mode, mv4, pred, cbp):
    """P macroblock header syntax elements (mb_skip_run, mb_type, sub
    types, mvds, cbp, mb_qp_delta = 0). Returns (vals (N, 16), lens
    (N, 16)) int64."""
    n = skip.shape[0]
    dev = skip.device
    coded = ~skip
    idx = torch.arange(n, device=dev)
    prev = torch.cummax(torch.where(coded, idx, -1), dim=0).values
    prev_before = torch.cat([torch.full((1,), -1, dtype=prev.dtype,
                                        device=dev), prev[:-1]])
    skip_run = idx - prev_before - 1
    vals = [skip_run + 1]
    lens = [torch.where(coded, ue_len(skip_run), 0)]
    mode = inter_mode.to(I64)
    vals.append(mode + 1)
    lens.append(torch.where(coded, ue_len(mode), 0))
    for _ in range(4):                     # sub_mb_type ue(0) = '1'
        vals.append(torch.ones(n, dtype=I64, device=dev))
        lens.append(torch.where(coded & (mode == 3), 1, 0))
    fb = on(FIRST_BLK, dev)[mode]          # (N, 4)
    npts = on(N_PARTS, dev)[mode]
    mv4 = mv4.to(I64)
    for p in range(4):
        mv = torch.gather(mv4, 1, fb[:, p, None, None].expand(n, 1, 2))[:, 0]
        mvd = mv - pred[:, p].to(I64)
        on_ = coded & (p < npts)
        for ax in range(2):
            k = se_to_ue(mvd[:, ax])
            vals.append(k + 1)
            lens.append(torch.where(on_, ue_len(k), 0))
    cbpc = on(CBP_INTER_INV, dev)[torch.clamp(cbp, 0, 47).long()].to(I64)
    vals.append(cbpc + 1)
    lens.append(torch.where(coded, ue_len(cbpc), 0))
    vals.append(torch.ones(n, dtype=I64, device=dev))       # se(0) = '1'
    lens.append(torch.where(coded & (cbp != 0), 1, 0))
    return (torch.stack(vals, dim=1) & MASK32, torch.stack(lens, dim=1))


# ---------------------------------------------------------------------------
# stream assembly
# ---------------------------------------------------------------------------

def assemble(piece_words, piece_lens, max_words: int, k_overlap: int = 8):
    """Concatenate variable-length pieces into one bit stream.

    piece_words (P, W) int64 big-endian 32-bit buffers; piece_lens (P,)
    bits. Returns (out (max_words,) int64, total_bits, ovf): ovf is set
    when some output word overlaps more than k_overlap non-empty pieces
    or the stream exceeds max_words (the caller then serializes on the
    host)."""
    P, W = piece_words.shape
    dev = piece_words.device
    piece_lens = piece_lens.to(I64)
    ends = torch.cumsum(piece_lens, dim=0)
    starts = ends - piece_lens
    total = ends[-1]

    # compact the non-empty pieces: slot j holds the j-th one. Empty
    # pieces scatter to the spare slot P, which is dropped (a scatter
    # with a data-dependent count would need a host sync).
    nz = piece_lens > 0
    tgt = torch.where(nz, torch.cumsum(nz.to(I64), dim=0) - 1, P)
    big = 2 ** 30
    pidx = torch.zeros(P + 1, dtype=I64, device=dev)
    cs = torch.full((P + 1,), big, dtype=I64, device=dev)
    ce = torch.full((P + 1,), big, dtype=I64, device=dev)
    pidx[tgt] = torch.arange(P, device=dev)
    cs[tgt] = starts
    ce[tgt] = ends
    pidx, cs, ce = pidx[:P], cs[:P].contiguous(), ce[:P].contiguous()

    w = torch.arange(max_words, dtype=I64, device=dev)
    bit0 = w * 32
    first = torch.searchsorted(ce, bit0, right=True)      # first end > bit0
    out = torch.zeros(max_words, dtype=I64, device=dev)
    flat = piece_words.reshape(-1)
    for k in range(k_overlap):
        ci = torch.clamp(first + k, 0, P - 1)
        pi = pidx[ci]
        s = cs[ci]
        e = ce[ci]
        live = (s < bit0 + 32) & (e > bit0) & (bit0 < total)
        off = bit0 - s                                    # may be negative
        l0 = off >> 5
        r = off & 31
        i0 = torch.clamp(pi * W + torch.clamp(l0, 0, W - 1), 0, P * W - 1)
        i1 = torch.clamp(pi * W + torch.clamp(l0 + 1, 0, W - 1), 0, P * W - 1)
        w0 = torch.where((l0 >= 0) & (l0 < W), flat[i0], 0)
        w1 = torch.where((l0 + 1 >= 0) & (l0 + 1 < W), flat[i1], 0)
        seg = torch.where(r == 0, w0,
                          ((w0 << torch.clamp(r, 0, 31)) & MASK32)
                          | (w1 >> torch.clamp(32 - r, 1, 31)))
        startb = torch.clamp(s - bit0, 0, 32)
        endb = torch.clamp(e - bit0, 0, 32)
        nbits = endb - startb
        msk = torch.where(
            nbits >= 32, MASK32,
            (((1 << torch.clamp(nbits, 0, 31)) - 1)
             << torch.clamp(32 - endb, 0, 31)) & MASK32)
        msk = torch.where(nbits > 0, msk, 0)
        out = out | torch.where(live, seg & msk, 0)

    lastp = torch.searchsorted(ce, bit0 + 32, right=False)
    ovf = ((lastp - first) > k_overlap - 1).any() | (total > max_words * 32)
    return out, total, ovf


# ---------------------------------------------------------------------------
# the fast-path P slice packer
# ---------------------------------------------------------------------------

def pack_p_body(skip, inter_mode, mv4, cbp, luma_scan, luma_nnz,
                chroma_dc, chroma_scan, chroma_nnz, mb_w: int, mb_h: int,
                max_words: int):
    """CAVLC slice_data of an all-inter P slice. Returns dict(words
    (max_words,) int64, nbits, ovf, bits_per_mb (N,))."""
    n = mb_w * mb_h
    dev = skip.device
    cbp = cbp.to(I64)
    pred = mv_pred_parts(mv4, inter_mode, mb_w, mb_h)
    hv, hl = header_slots(skip, inter_mode, mv4, pred, cbp)
    hw, hbits = fold_slots(hv, hl, HEADER_WORDS)

    ncl = nc_luma_field(luma_nnz, mb_w, mb_h)
    lv, ll, lovf = block_slots(luma_scan.reshape(n * 16, 16),
                               ncl.reshape(n * 16), 16)
    lw, lbits = fold_slots(lv, ll, BLOCK_WORDS)

    dv, dl, dovf = block_slots(
        chroma_dc.reshape(n * 2, 4),
        torch.full((n * 2,), -1, dtype=I64, device=dev), 4)
    dw, dbits = fold_slots(dv, dl, BLOCK_WORDS)

    ncc = nc_chroma_field(chroma_nnz, mb_w, mb_h)
    av, al, aovf = block_slots(chroma_scan.reshape(n * 8, 16)[:, 1:],
                               ncc.reshape(n * 8), 15)
    aw, abits = fold_slots(av, al, BLOCK_WORDS)

    # gates: per MB [header, luma x16 (write order), dc x2, ac x8]
    coded = ~skip
    cbp_l = cbp & 15
    cbp_c = cbp >> 4
    wo = on(WRITE_ORDER, dev)
    luma_gate = coded[:, None] & \
        (((cbp_l[:, None] >> (torch.arange(16, device=dev) // 4)) & 1) != 0)
    lw_mb = lw.reshape(n, 16, BLOCK_WORDS)[:, wo]
    lb_mb = lbits.reshape(n, 16)[:, wo]
    dc_gate = (coded & (cbp_c >= 1))[:, None].expand(n, 2)
    ac_gate = (coded & (cbp_c >= 2))[:, None].expand(n, 8)
    piece_words = torch.cat([
        hw[:, None], lw_mb, dw.reshape(n, 2, BLOCK_WORDS),
        aw.reshape(n, 8, BLOCK_WORDS)], dim=1)            # (N, 27, W)
    piece_lens = torch.cat([
        torch.where(coded, hbits, 0)[:, None],
        torch.where(luma_gate, lb_mb, 0),
        torch.where(dc_gate, dbits.reshape(n, 2), 0),
        torch.where(ac_gate, abits.reshape(n, 8), 0)], dim=1)

    # trailing mb_skip_run (MBWriter.finish)
    idx = torch.arange(n, device=dev)
    last_coded = torch.where(coded, idx, -1).max()
    tail_run = n - 1 - last_coded
    tail_len = torch.where(tail_run > 0, ue_len(tail_run), 0)
    tail_words = torch.zeros((1, BLOCK_WORDS), dtype=I64, device=dev)
    tail_words[0, 0] = torch.where(
        tail_len > 0,
        ((tail_run + 1) << torch.clamp(32 - tail_len, 0, 31)) & MASK32, 0)
    bits_per_mb = piece_lens.sum(dim=1)
    piece_words = torch.cat([piece_words.reshape(n * PIECES_PER_MB,
                                                 BLOCK_WORDS), tail_words])
    piece_lens = torch.cat([piece_lens.reshape(n * PIECES_PER_MB),
                            tail_len[None]])
    words, nbits, aovf2 = assemble(piece_words, piece_lens, max_words,
                                   k_overlap=16)
    cap_ovf = ((lbits > 32 * BLOCK_WORDS).any()
               | (abits > 32 * BLOCK_WORDS).any()
               | (hbits > 32 * HEADER_WORDS).any())
    return {
        "words": words,
        "nbits": nbits,
        "ovf": lovf.any() | dovf.any() | aovf.any() | aovf2 | cap_ovf,
        "bits_per_mb": bits_per_mb,
    }


def pack_p_slice_full(inter_mode, mv4, cbp, luma_scan, luma_nnz, chroma_dc,
                      chroma_scan, chroma_nnz, *, mb_w: int, mb_h: int,
                      max_words: int):
    """pack_p_body with the P_Skip derivation; the skip mask is returned
    under "skip"."""
    skip = skip_field(inter_mode, cbp, mv4, mb_w, mb_h)
    out = pack_p_body(skip, inter_mode, mv4, cbp, luma_scan, luma_nnz,
                      chroma_dc, chroma_scan, chroma_nnz, mb_w, mb_h,
                      max_words)
    out["skip"] = skip
    return out
