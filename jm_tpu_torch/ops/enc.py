"""Whole-picture P-frame encode on tensors (twin of the P fast path of
jm_tpu/ops/enc_jax.py, both tiers).

One call encodes every macroblock of a P picture as batched tensor ops:

  integer full-search ME (quadrant SADs of every MB per displacement)
  -> dense quarter-pel SATD refinement of all 9 partition jobs
  -> skip / intra-16 triggers
  -> mode decision: the trial-encode RD (ops/enc_rd.py, rd=True) or
     md_low's cost-based choice with its motion compensation and
     residual coding (rd=False)
  -> boundary strengths + in-loop deblock (ops/deblock.py; the CUDA
     kernels on the card)
  -> next-reference prep (quarter-pel planes, padded chroma)
  -> CAVLC slice pack (ops/cavlc.py)

(lencod/src/slice.c:486 MB loop, md_high.c:38, mv_search.c
PartitionMotionSearch, block.c residual coding, as one batched program.)
Integer-exact: CPU and GPU give the same bits as jm_tpu.

Windows into the reference ("bands"): enc_jax cuts the padded planes
into per-MB-column bands (build_band / build_cband) and extracts windows
by row gather + one-hot column matmul. Here a window is one index gather
straight from the planes: band m, row r, column c of luma is
planes[:, r, PAD - off + 16 m + c], columns outside [0, band width) read
zero, and the row start clamps like lax.dynamic_slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.tables import ZIGZAG_4x4
from . import quant as Q
from . import transform as T
from .cavlc import median3
from .consts import PAD, QPEL_TAB, on

I32 = torch.int32


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------

ZZ = np.asarray(ZIGZAG_4x4, np.int64)
INV_ZZ = np.argsort(ZZ)

# se(v) bit length, indexed by |v|
SE_BITS = np.array([1] + [2 * int(2 * a).bit_length() - 1
                          for a in range(1, 4096)], np.int32)

# partition jobs: 0=16x16, 1/2=16x8 top/bottom, 3/4=8x16 left/right,
# 5..8 = 8x8 quadrants
JOB_QUADS = [(0, 1, 2, 3), (0, 1), (2, 3), (0, 2), (1, 3),
             (0,), (1,), (2,), (3,)]
# quadrant-level subpel jobs (qjobs): each (parent job, quadrant), in
# parent order
QJ_PARENT = np.array([j for j, qs in enumerate(JOB_QUADS) for _ in qs],
                     np.int64)                        # (16,)
QJ_QUAD = np.array([q for qs in JOB_QUADS for q in qs], np.int64)
MODE_BITS = np.array([1, 3, 3, 9], np.int32)
MODE_JOBS = [(0,), (1, 2), (3, 4), (5, 6, 7, 8)]
BLK_JOB = np.zeros((4, 16), np.int64)
for _m, _jobs in enumerate(MODE_JOBS):
    for _blk in range(16):
        _by, _bx = divmod(_blk, 4)
        _q = (_by // 2) * 2 + (_bx // 2)
        BLK_JOB[_m, _blk] = next(j for j in _jobs if _q in JOB_QUADS[j])
QUAD_X = np.array([0, 1, 0, 1], np.int64)
QUAD_Y = np.array([0, 0, 1, 1], np.int64)
BLK_QUAD = np.array([(b // 8) * 2 + ((b % 4) // 2) for b in range(16)],
                    np.int64)
QUAD_BLKS = np.array([[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13],
                      [10, 11, 14, 15]], np.int64)      # raster blocks of a quad
QUAD_BITS = np.array([1, 2, 4, 8], np.int32)            # cbp bit of each quad
# md_low's quadrant motion: the job serving each quad under each mode
QUAD_JOB = BLK_JOB[:, [0, 2, 8, 10]]

# refinement candidates: center first so ties keep the center
DELTAS = [(0, 0)] + [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                     if (dx, dy) != (0, 0)]

# JM coefficient-thresholding table (lencod block.c COEFF_COST4x4:72)
CC4 = np.array([3, 2, 2, 1, 1, 1] + [0] * 10, np.int32)
CC_BIG = 1 << 20


def quads_to_jobs(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) per-quadrant sums -> (..., 9) per-job sums (exact)."""
    return torch.stack([sum(q[..., i] for i in qs) for qs in JOB_QUADS],
                       dim=-1)


def qjobs_to_jobs(s: torch.Tensor) -> torch.Tensor:
    """(..., 16) per-qjob values -> (..., 9) per-parent-job sums."""
    out, k = [], 0
    for qs in JOB_QUADS:
        out.append(s[..., k:k + len(qs)].sum(-1))
        k += len(qs)
    return torch.stack(out, dim=-1)


def se_bits(v: torch.Tensor) -> torch.Tensor:
    return on(SE_BITS, v.device)[torch.clamp(torch.abs(v), 0, 4095).long()]


def mb_tiles(plane: torch.Tensor, mb_h: int, mb_w: int, s: int):
    """(s mb_h, s mb_w) plane -> (N, s, s) MB tiles in raster order."""
    return plane.reshape(mb_h, s, mb_w, s).permute(0, 2, 1, 3) \
        .reshape(mb_h * mb_w, s, s)


def mb_untile(tiles: torch.Tensor, mb_h: int, mb_w: int, s: int):
    return tiles.reshape(mb_h, mb_w, s, s).permute(0, 2, 1, 3) \
        .reshape(mb_h * s, mb_w * s)


# ---------------------------------------------------------------------------
# reference preparation (twin of make_luma_planes_dev / prep_ref)
# ---------------------------------------------------------------------------

def _conv6_h(x):
    return (x[:, 0:-5] - 5 * x[:, 1:-4] + 20 * x[:, 2:-3]
            + 20 * x[:, 3:-2] - 5 * x[:, 4:-1] + x[:, 5:])


def _conv6_v(x):
    return (x[0:-5, :] - 5 * x[1:-4, :] + 20 * x[2:-3, :]
            + 20 * x[3:-2, :] - 5 * x[4:-1, :] + x[5:, :])


def edge_pad(plane: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad a 2-D plane by p on every side (np.pad 'edge')."""
    h, w = plane.shape
    rows = torch.clamp(torch.arange(-p, h + p, device=plane.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-p, w + p, device=plane.device), 0, w - 1)
    return plane[rows][:, cols]


def make_luma_planes(plane: torch.Tensor, pad: int = PAD,
                     cmax: int = 255) -> torch.Tensor:
    """(H, W) -> (4, H+2p, W+2p) stacked [INT, B, H, J] quarter-pel
    source planes (spec 8.4.2.2.1 six-tap half samples) of the plane's
    dtype (uint8, or int16 above 8 bits), the half samples clipped at
    cmax = (1 << bitDepth) - 1 (jm_tpu/ops/interp.py make_luma_planes)."""
    h, w = plane.shape
    ext = edge_pad(plane, pad + 3).to(I32)
    b1 = _conv6_h(ext)
    h1 = _conv6_v(ext)
    B = torch.clamp((b1 + 16) >> 5, 0, cmax)
    H = torch.clamp((h1 + 16) >> 5, 0, cmax)
    J = torch.clamp((_conv6_v(b1) + 512) >> 10, 0, cmax)
    p = pad
    INT = ext[3:3 + h + 2 * p, 3:3 + w + 2 * p]
    Bc = B[3:3 + h + 2 * p, 1:1 + w + 2 * p]
    Hc = H[1:1 + h + 2 * p, 3:3 + w + 2 * p]
    Jc = J[1:1 + h + 2 * p, 1:1 + w + 2 * p]
    return torch.stack([INT, Bc, Hc, Jc]).to(plane.dtype)


def prep_ref(Y: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
             bd_luma: int = 8):
    """Reference state of a decoded picture: (planes (4, H+2P, W+2P),
    padU, padV) of the planes' dtype (lencod img_luma.c
    getSubImagesLuma:611 twin); bd_luma the luma bit depth."""
    return (make_luma_planes(Y, cmax=(1 << bd_luma) - 1),
            edge_pad(U, PAD), edge_pad(V, PAD))


# ---------------------------------------------------------------------------
# integer full search
# ---------------------------------------------------------------------------

def me_int_sweep(origY, ref_int, mb_w: int, mb_h: int, sr: int, lam: int,
                 y0: int = -PAD, band_y0: int = 0):
    """Integer-pel full search of all 9 partition jobs of every MB.

    origY (H, W) uint8, or an MB-row band of it whose first row is
    picture row band_y0; ref_int the padded integer plane (pad PAD), its
    row 0 picture row y0 (-PAD for the whole picture's plane).
    Cost = SAD + lam * (se_bits(4 dx) + se_bits(4 dy)) (zero predictor).
    Returns (mv (N, 9, 2) int32, cost (N, 9) int32). Displacements are
    visited row by row, left to right, keeping the first minimum — one
    row's (2 sr + 1) candidates are evaluated together. Sums are float32,
    exact below 2^24 (every SAD here is < 2^17)."""
    side = 2 * sr + 1
    h, w = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    dev = origY.device
    r0 = band_y0 - sr - y0
    region = ref_int[r0:r0 + h + 2 * sr,
                     PAD - sr:PAD - sr + w + 2 * sr].to(torch.float32)
    o = origY.to(torch.float32)
    se = on(SE_BITS, dev)
    dxs = torch.arange(side, device=dev)
    bits_x = lam * se[torch.abs(4 * (dxs - sr))]                 # (side,)
    best_cost = torch.full((n, 9), 2 ** 30, dtype=I32, device=dev)
    best_idx = torch.zeros((n, 9), dtype=torch.int64, device=dev)
    for dy in range(side):
        row = region[dy:dy + h]                                   # (h, w+2sr)
        cand = row.unfold(1, w, 1)                                # (h, side, w)
        d = torch.abs(o[:, None, :] - cand)
        d2 = d.reshape(h, side, w // 8, 8).sum(-1)                # (h, side, w/8)
        q8 = d2.reshape(mb_h * 2, 8, side, w // 8).sum(1)         # (2mh, side, w/8)
        sad_q = q8.reshape(mb_h, 2, side, mb_w, 2).permute(2, 0, 3, 1, 4) \
            .reshape(side, n, 4)
        bits_y = lam * int(SE_BITS[abs(4 * (dy - sr))])
        cost = quads_to_jobs(sad_q).to(I32) + (bits_y + bits_x)[:, None, None]
        c_min, c_arg = cost.min(dim=0)                            # first min
        upd = c_min < best_cost
        best_cost = torch.where(upd, c_min, best_cost)
        best_idx = torch.where(upd, dy * side + c_arg, best_idx)
    mv = torch.stack([best_idx % side - sr, best_idx // side - sr], dim=-1)
    return mv.to(I32), best_cost


# ---------------------------------------------------------------------------
# SATD, predictors, intra-16 trigger
# ---------------------------------------------------------------------------

def _check_host_range(sr: int) -> None:
    """The host coders' full search reads the planes' PAD rows and
    columns: a wider range raises, as jm_tpu's encoder/me.py slicing
    does (at the first P or B picture)."""
    if sr > PAD:
        raise ValueError(f"search range {sr} exceeds the host coders' plane "
                         f"padding {PAD}")


def full_search_sad_quad(origY, ref_int, mb_w: int, mb_h: int, sr: int):
    """The SAD of each 8x8 quadrant of every MB at every integer
    displacement of the +-sr window: (N, (2 sr + 1)^2, 4) int32, row-major
    (dy, dx), quadrants in raster order: the host P coder's integer search
    table (jm_tpu/encoder/me.py full_search_blk4_sads summed over each
    quadrant's 4x4 blocks, QUAD_BLKS; the per-4x4 table,
    full_search_sad_blk4, is made only for the sub-8x8 search). origY
    (H, W) uint8; ref_int the padded integer plane (pad PAD). One row of
    displacements is evaluated at a time."""
    _check_host_range(sr)
    side = 2 * sr + 1
    h, w = 16 * mb_h, 16 * mb_w
    n = mb_w * mb_h
    o = origY.to(torch.int16)
    out = torch.empty((n, side * side, 4), dtype=I32, device=origY.device)
    for iy in range(side):
        y0 = PAD + iy - sr
        slab = ref_int[y0:y0 + h, PAD - sr:PAD + sr + w].to(torch.int16)
        d = (slab.unfold(1, w, 1) - o[:, None, :]).abs()     # (h, side, w)
        s = d.reshape(mb_h, 2, 8, side, mb_w, 2, 8).sum(dim=(2, 6),
                                                        dtype=I32)
        # (mb_h, qy, side, mb_w, qx) -> (N, side, 4)
        out[:, iy * side:(iy + 1) * side] = s.permute(0, 3, 2, 1, 4) \
            .reshape(n, side, 4)
    return out


def full_search_sad_blk4(origY, ref_int, mb_w: int, mb_h: int, sr: int):
    """The SAD of each 4x4 block of every MB at every integer displacement
    of the +-sr window: (N, (2 sr + 1)^2, 16) int16 (a 4x4 SAD is at most
    16 * 255 = 4080), row-major (dy, dx), blocks in raster order in the
    MB: jm_tpu/encoder/me.py full_search_blk4_sads, the host P coder's
    table when it searches sub-8x8 partitions by full search (the sums of
    its quadrants' blocks are full_search_sad_quad). origY (H, W) uint8;
    ref_int the padded integer plane (pad PAD). One row of displacements
    is evaluated at a time."""
    _check_host_range(sr)
    side = 2 * sr + 1
    h, w = 16 * mb_h, 16 * mb_w
    n = mb_w * mb_h
    o = origY.to(torch.int16)
    out = torch.empty((n, side * side, 16), dtype=torch.int16,
                      device=origY.device)
    for iy in range(side):
        y0 = PAD + iy - sr
        slab = ref_int[y0:y0 + h, PAD - sr:PAD + sr + w].to(torch.int16)
        d = (slab.unfold(1, w, 1) - o[:, None, :]).abs()     # (h, side, w)
        s = d.reshape(mb_h, 4, 4, side, mb_w, 4, 4).sum(dim=(2, 6),
                                                        dtype=I32)
        # (mb_h, by, side, mb_w, bx) -> (N, side, 16)
        out[:, iy * side:(iy + 1) * side] = s.permute(0, 3, 2, 1, 4) \
            .reshape(n, side, 16).to(torch.int16)
    return out


def full_search_sad16(origY, ref_int, mb_w: int, mb_h: int, sr: int):
    """The 16x16 SAD of every MB at every integer displacement of the
    +-sr window: (N, (2 sr + 1)^2) int32, row-major (dy, dx), the B
    macroblock coder's integer search table (jm_tpu/encoder/me.py
    full_search_blk4_sads(...).sum(axis=2)): the sum of the four columns
    of full_search_sad_quad."""
    return full_search_sad_quad(origY, ref_int, mb_w, mb_h, sr).sum(
        dim=2, dtype=I32)


def satd8_raw(diff: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) int32 -> (...,) sum over the four 4x4 tiles of
    sum |H d H^T| (no final >> 1)."""
    d = diff.reshape(*diff.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)
    d0, d1, d2, d3 = d[..., 0, :], d[..., 1, :], d[..., 2, :], d[..., 3, :]
    p0, p1, m0, m1 = d0 + d3, d1 + d2, d0 - d3, d1 - d2
    a = torch.stack([p0 + p1, m0 + m1, p0 - p1, m0 - m1], dim=-2)
    e0, e1, e2, e3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    q0, q1, n0, n1 = e0 + e3, e1 + e2, e0 - e3, e1 - e2
    b = torch.stack([q0 + q1, n0 + n1, q0 - q1, n0 - n1], dim=-1)
    return torch.abs(b).sum(dim=(-4, -3, -2, -1))


def approx_pred_field(mv16: torch.Tensor, mb_w: int, mb_h: int,
                      up_halo=None, is_first: bool = True):
    """Median of the (left, up, up-right) integer 16x16 MVs in qpel units
    as each MB's approximate predictor; missing neighbours count as
    zero, and the picture's first MB row uses its left neighbour.
    (N, 2) int32. For an MB-row band: up_halo, the (mb_w, 2) integer MVs
    of the MB row above it (zeros above the picture); is_first, whether
    it holds the picture's first MB row."""
    f = (mv16 * 4).reshape(mb_h, mb_w, 2)
    z = torch.zeros_like(f)
    if up_halo is None:
        up0 = upr0 = z[:1]
    else:
        up0 = (up_halo * 4).reshape(1, mb_w, 2).to(f.dtype)
        upr0 = torch.cat([up0[:, 1:], up0[:, -1:]], dim=1)
    left = torch.cat([z[:, :1], f[:, :-1]], dim=1)
    up = torch.cat([up0, f[:-1]], dim=0)
    upr = torch.cat([upr0, torch.cat([f[:-1, 1:], f[:-1, -1:]], dim=1)],
                    dim=0)
    med = median3(left, up, upr)
    row0 = (torch.arange(mb_h, device=f.device) == 0)[:, None, None] \
        & is_first
    med = torch.where(row0, left, med)
    return med.reshape(mb_h * mb_w, 2).to(I32)


def i16_source_cost(origY: torch.Tensor, mb_w: int, mb_h: int,
                    top_halo=None, is_first: bool = True):
    """Per-MB best-of-4 Intra16x16 SAD from SOURCE neighbours (the P
    frame's intra trigger). (N,) int32. For an MB-row band: top_halo, the
    (W,) source row above it; is_first, whether it holds the picture's
    row 0, whose MBs have no top neighbour."""
    dev = origY.device
    o = origY.to(I32)
    mbs = o.reshape(mb_h, 16, mb_w, 16).permute(0, 2, 1, 3)
    if top_halo is None:
        top_idx = torch.clamp(torch.arange(mb_h, device=dev) * 16 - 1,
                              min=0)
        top_rows = o[top_idx]                                  # (mh, W)
    else:
        top_rows = torch.cat([top_halo[None].to(I32), o])[
            torch.arange(mb_h, device=dev) * 16]
    top = top_rows.reshape(mb_h, mb_w, 16)
    left_idx = torch.clamp(torch.arange(mb_w, device=dev) * 16 - 1, min=0)
    left = o[:, left_idx].reshape(mb_h, 16, mb_w).permute(0, 2, 1)
    corner = top_rows[:, left_idx]                             # (mh, mw)
    avail_t = ((torch.arange(mb_h, device=dev) > 0) | (not is_first))[
        :, None].expand(mb_h, mb_w)
    avail_l = (torch.arange(mb_w, device=dev) > 0)[None, :] \
        .expand(mb_h, mb_w)

    def sad(p):
        return torch.abs(mbs - p).sum(dim=(2, 3))

    big = 2 ** 28
    s_t = top.sum(dim=2)
    s_l = left.sum(dim=2)
    dc = torch.where(avail_t & avail_l, (s_t + s_l + 16) >> 5,
                     torch.where(avail_t, (s_t + 8) >> 4,
                                 torch.where(avail_l, (s_l + 8) >> 4, 128)))
    c_dc = sad(dc[:, :, None, None])
    c_v = torch.where(avail_t, sad(top[:, :, None, :]), big)
    c_h = torch.where(avail_l, sad(left[:, :, :, None]), big)
    iw = torch.arange(1, 9, device=dev)
    top_ext = torch.cat([corner[:, :, None], top], dim=2)      # p[-1..15]
    left_ext = torch.cat([corner[:, :, None], left], dim=2)
    Hs = (iw * (top_ext[:, :, 8 + iw] - top_ext[:, :, 8 - iw])).sum(dim=2)
    Vs = (iw * (left_ext[:, :, 8 + iw] - left_ext[:, :, 8 - iw])).sum(dim=2)
    b = (5 * Hs + 32) >> 6
    c = (5 * Vs + 32) >> 6
    a = 16 * (top[:, :, 15] + left[:, :, 15])
    yy, xx = torch.meshgrid(torch.arange(16, device=dev),
                            torch.arange(16, device=dev), indexing="ij")
    pl = (a[:, :, None, None] + b[:, :, None, None] * (xx - 7)
          + c[:, :, None, None] * (yy - 7) + 16) >> 5
    pl = torch.clamp(pl, 0, 255)
    c_p = torch.where(avail_t & avail_l, sad(pl), big)
    cost = torch.minimum(torch.minimum(c_dc, c_v), torch.minimum(c_h, c_p))
    return cost.reshape(mb_h * mb_w).to(I32)


# ---------------------------------------------------------------------------
# residual coding helpers
# ---------------------------------------------------------------------------

def to_scan(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 16) zig-zag order."""
    return blocks.reshape(*blocks.shape[:-2], 16)[..., on(ZZ, blocks.device)]


def from_scan(scan: torch.Tensor) -> torch.Tensor:
    """(..., 16) zig-zag -> (..., 4, 4) raster."""
    return scan[..., on(INV_ZZ, scan.device)].reshape(*scan.shape[:-1], 4, 4)


def coeff_cost(scan: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Run-weighted coefficient cost (..., 16) -> (...,) (JM
    COEFF_COST4x4 with the > 1 level override)."""
    s = scan[..., start:].to(I32)
    k = s.shape[-1]
    nz = s != 0
    idx = torch.arange(k, device=s.device).expand(s.shape)
    prev = torch.cummax(torch.where(nz, idx, -1), dim=-1).values
    prev = torch.cat([torch.full((*s.shape[:-1], 1), -1, dtype=prev.dtype,
                                 device=s.device), prev[..., :-1]], dim=-1)
    run = idx - prev - 1
    c = torch.where(torch.abs(s) > 1, CC_BIG,
                    on(CC4, s.device)[torch.clamp(run, 0, 15)])
    return torch.where(nz, c, 0).sum(dim=-1)


def chroma_residual(origU, origV, predU, predV, qpc: int, intra: bool):
    """4:2:0 chroma residual of (B, 8, 8) blocks: 2x2 DC Hadamard, AC
    thresholding (block.c:1141), cbp and recon (residual_np twin).
    Returns (dc (B,2,4), ac_scan (B,2,4,16), nnz (B,2,4), cbp_c (B,),
    recU, recV (B,8,8) uint8), all int32 but the recon."""
    n = origU.shape[0]
    dev = origU.device
    o = torch.stack([origU, origV], dim=1).to(I32)
    p = torch.stack([predU, predV], dim=1).to(I32)
    blocks = (o - p).reshape(n, 2, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5) \
        .reshape(n, 2, 4, 4, 4)
    wt = T.forward4x4(blocks)
    dc_t = T.hadamard2x2(wt[..., 0, 0].reshape(n, 2, 2, 2))
    qpv = torch.full((n, 2), qpc, dtype=I32, device=dev)
    dc_lev = Q.quant_chroma_dc(dc_t, qpv[..., None, None], intra) \
        .reshape(n, 2, 4)
    ac_scan = to_scan(Q.quant_4x4(wt, qpv[..., None], intra))
    ac_scan[..., 0] = 0
    cost_c = coeff_cost(ac_scan, start=1).sum(dim=2)             # (B, 2)
    ac_scan = torch.where((cost_c >= 4)[..., None, None], ac_scan, 0)
    any_ac = (ac_scan[..., 1:] != 0).any(dim=3).any(dim=2).any(dim=1)
    any_dc = (dc_lev != 0).any(dim=2).any(dim=1)
    cbp_c = torch.where(any_ac, 2, torch.where(any_dc, 1, 0)).to(I32)
    ac_scan = torch.where((cbp_c < 2)[:, None, None, None], 0, ac_scan)
    dc_lev = torch.where((cbp_c == 0)[:, None, None], 0, dc_lev)
    nnz = (ac_scan[..., 1:] != 0).sum(dim=3).to(I32)
    d4 = Q.dequant_4x4(from_scan(ac_scan), qpv[..., None])
    f = T.hadamard2x2(dc_lev.reshape(n, 2, 2, 2))
    scale = Q.dc_scale(qpv)[..., None, None]
    dc_s = ((f * scale) << (qpv[..., None, None] // 6)) >> 5
    d4[..., 0, 0] = dc_s.reshape(n, 2, 4)
    r = T.inverse4x4_round(d4)
    pred_b = p.reshape(n, 2, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5) \
        .reshape(n, 2, 4, 4, 4)
    rec = torch.clamp(pred_b + r, 0, 255)
    rec = rec.reshape(n, 2, 2, 2, 4, 4).permute(0, 1, 2, 4, 3, 5) \
        .reshape(n, 2, 8, 8).to(torch.uint8)
    return dc_lev.to(I32), ac_scan.to(I32), nnz, cbp_c, rec[:, 0], rec[:, 1]


def luma_residual_inter(orig, pred, qp: int):
    """Inter luma residual of (N, 16, 16) MBs: 4x4 transform and quant,
    JM's coefficient thresholding (macroblock.c:901,1248: an 8x8 quadrant
    costing at most 4 is dropped, then the whole MB if what is left costs
    at most 5), recon (enc_jax.luma_residual_inter twin). Returns (scan
    (N, 16, 16), nnz (N, 16), cbp_luma (N,), rec (N, 16, 16) uint8), all
    int32 but the recon."""
    n = orig.shape[0]
    dev = orig.device
    blocks = (orig.to(I32) - pred.to(I32)).reshape(n, 4, 4, 4, 4) \
        .permute(0, 1, 3, 2, 4).reshape(n, 16, 4, 4)
    qpv = torch.full((n, 16), qp, dtype=I32, device=dev)
    scan = to_scan(Q.quant_4x4(T.forward4x4(blocks), qpv, False))
    quad_blks = on(QUAD_BLKS, dev)
    cost_q = coeff_cost(scan)[:, quad_blks].sum(dim=2)          # (N, 4)
    keep_q = cost_q > 4
    keep_mb = torch.where(keep_q, cost_q, 0).sum(dim=1) > 5
    keep_blk = keep_q[:, on(BLK_QUAD, dev)] & keep_mb[:, None]
    scan = torch.where(keep_blk[..., None], scan, 0)
    r = T.inverse4x4_round(Q.dequant_4x4(from_scan(scan), qpv))
    pred_b = pred.to(I32).reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 4, 4)
    rec = torch.clamp(pred_b + r, 0, 255).reshape(n, 4, 4, 4, 4) \
        .permute(0, 1, 3, 2, 4).reshape(n, 16, 16).to(torch.uint8)
    nnz = (scan != 0).sum(dim=2).to(I32)
    cbp = ((nnz[:, quad_blks].sum(dim=2) > 0).to(I32)
           * on(QUAD_BITS, dev)).sum(dim=1)
    return scan.to(I32), nnz, cbp.to(I32), rec


# ---------------------------------------------------------------------------
# reference windows
# ---------------------------------------------------------------------------

def band_geometry(sr: int):
    """(offset, width) of the per-MB-column luma band for search range sr:
    band m spans picture columns [16m - off, 16m - off + width)."""
    off = sr + 8
    width = -(-(16 + 2 * off) // 32) * 32
    off = (width - 16) // 2
    if off > PAD:
        raise ValueError(f"search range {sr} exceeds plane padding")
    return off, width


def cband_geometry(sr: int):
    off = (4 * sr + 6) // 8 + 3
    width = -(-(8 + 2 * off) // 16) * 16
    off = (width - 8) // 2
    if off > PAD:
        raise ValueError(f"search range {sr} exceeds chroma padding")
    return off, width


def band_windows(planes, mb_idx, r0, c0, nrows: int, ncols: int,
                 mb_size: int, off: int, width: int):
    """(Q,) band index, window top row r0 (padded-plane row) and band
    column c0 -> (Q, P, nrows, ncols) int32 windows of the (P, Hp, Wp)
    planes. Band m column c is plane column PAD - off + mb_size m + c;
    columns outside [0, width) are zero. The row start follows
    lax.dynamic_slice: a negative start counts from the end, then the
    start is clamped to [0, Hp - nrows]."""
    _, Hp, Wp = planes.shape
    dev = planes.device
    r0 = r0.long()
    r0 = torch.where(r0 < 0, r0 + Hp, r0)      # lax.dynamic_slice wraps
    rows = torch.clamp(r0, 0, Hp - nrows)[:, None] \
        + torch.arange(nrows, device=dev)[None]                 # (Q, R)
    cb = c0.long()[:, None] + torch.arange(ncols, device=dev)[None]
    ok = (cb >= 0) & (cb < width)                               # (Q, C)
    cols = PAD - off + mb_size * mb_idx.long()[:, None] \
        + torch.clamp(cb, 0, width - 1)
    cols = torch.clamp(cols, 0, Wp - 1)
    win = planes[:, rows[:, :, None], cols[:, None, :]]         # (P, Q, R, C)
    win = torch.where(ok[None, :, None, :], win.to(I32), 0)
    return win.permute(1, 0, 2, 3)


def qpel_block_at(win, tx: int, ty: int, bs: int = 8):
    """Block at window-relative quarter-pel position (tx, ty) (window
    anchored one integer sample up-left): (Q, 4, R, C) -> (Q, bs, bs)."""
    xi, xf = tx >> 2, tx & 3
    yi, yf = ty >> 2, ty & 3
    p1, dx1, dy1, p2, dx2, dy2 = QPEL_TAB[(xf, yf)]
    a = win[:, p1, yi + dy1:yi + dy1 + bs, xi + dx1:xi + dx1 + bs]
    if p2 < 0:
        return a
    b = win[:, p2, yi + dy2:yi + dy2 + bs, xi + dx2:xi + dx2 + bs]
    return (a + b + 1) >> 1


def qpel_refine_dense(planes, orig_q, int_mv, pred, lam: int, mb_xy,
                      sr: int, y0: int = -PAD):
    """Two-stage (half, then quarter) 3x3 refinement of all 9 partition
    jobs per MB, evaluated densely: SATD at every position of the 7x7
    quarter-pel grid around each job's integer MV, then the sequential
    two-stage strict-< argmin (center first) on the cost grid.

    orig_q (N, 4, 8, 8); int_mv (N, 9, 2); pred (N, 2) qpel predictor;
    mb_xy (N, 2) MB pixel origin; y0 the picture row of the planes' row
    0 (-PAD for the whole picture's). Returns (mv_q (N, 9, 2) int32,
    cost_q (N, 9), win (N*16, 4, 10, 10) int32 refine windows).
    jm_tpu's MB-row bands call subpel_refine_jobs, its two-stage search
    over gathered windows: the same search, the same values over the
    same plane rows, so the port's bands take this form at their y0."""
    n = int_mv.shape[0]
    dev = int_mv.device
    off, width = band_geometry(sr)
    qj_parent = on(QJ_PARENT, dev)
    qj_quad = on(QJ_QUAD, dev)
    oq = orig_q[:, qj_quad].to(I32).reshape(-1, 8, 8)          # (NQ, 8, 8)
    qoff_x = (qj_quad % 2) * 8
    qoff_y = (qj_quad // 2) * 8
    cmx = int_mv[:, qj_parent, 0]                              # (N, 16)
    cmy = int_mv[:, qj_parent, 1]
    mb_idx = (mb_xy[:, 0:1] // 16).expand(n, 16)
    r0 = mb_xy[:, 1:2] + qoff_y[None] + cmy - 1 - y0
    c0 = qoff_x[None] + cmx - 1 + off
    win = band_windows(planes, mb_idx.reshape(-1), r0.reshape(-1),
                       c0.reshape(-1), 10, 10, 16, off, width)

    grid = []
    for ty in range(1, 8):
        for tx in range(1, 8):
            s = satd8_raw(oq - qpel_block_at(win, tx, ty)).reshape(n, 16)
            grid.append(qjobs_to_jobs(s) >> 1)                 # (N, 9)
    grid = torch.stack(grid, dim=-1).reshape(n, 9, 7, 7)       # [.., ty-1, tx-1]

    tj = torch.arange(1, 8, device=dev)
    mvx_all = 4 * int_mv[..., 0:1] + (tj - 4)[None, None]       # (N, 9, 7)
    mvy_all = 4 * int_mv[..., 1:2] + (tj - 4)[None, None]
    bits_x = se_bits(mvx_all - pred[:, None, 0:1])
    bits_y = se_bits(mvy_all - pred[:, None, 1:2])
    cost = grid + lam * (bits_y[..., :, None] + bits_x[..., None, :])

    best = None
    for (dx, dy) in DELTAS:
        c = cost[..., 3 + 2 * dy, 3 + 2 * dx]
        if best is None:
            best = (c, torch.zeros_like(c), torch.zeros_like(c))
        else:
            bc, bdx, bdy = best
            upd = c < bc
            best = (torch.where(upd, c, bc), torch.where(upd, dx, bdx),
                    torch.where(upd, dy, bdy))
    cost_h, hdx, hdy = best

    best = None
    for (dx, dy) in DELTAS:
        c = torch.zeros_like(cost_h)
        for sx in (-1, 0, 1):
            for sy in (-1, 0, 1):
                sel = (hdx == sx) & (hdy == sy)
                c = torch.where(sel, cost[..., 3 + 2 * sy + dy,
                                          3 + 2 * sx + dx], c)
        if best is None:
            best = (c, torch.zeros_like(c), torch.zeros_like(c))
        else:
            bc, bdx, bdy = best
            upd = c < bc
            best = (torch.where(upd, c, bc), torch.where(upd, dx, bdx),
                    torch.where(upd, dy, bdy))
    cost_q, qdx, qdy = best
    mvq = torch.stack([4 * int_mv[..., 0] + 2 * hdx + qdx,
                       4 * int_mv[..., 1] + 2 * hdy + qdy], dim=-1)
    return mvq.to(I32), cost_q.to(I32), win


def qjob_pred_blocks(win, mv_q, int_mv):
    """Each qjob's 8x8 prediction at its chosen sub-pel offset, selected
    from the refine windows. Returns (N, 16, 8, 8) int32 (qjob order)."""
    n = mv_q.shape[0]
    qj_parent = on(QJ_PARENT, mv_q.device)
    tx = (mv_q[..., 0] - 4 * int_mv[..., 0] + 4)[:, qj_parent].reshape(-1)
    ty = (mv_q[..., 1] - 4 * int_mv[..., 1] + 4)[:, qj_parent].reshape(-1)
    out = torch.zeros((n * 16, 8, 8), dtype=I32, device=mv_q.device)
    for t_y in range(1, 8):
        for t_x in range(1, 8):
            sel = ((tx == t_x) & (ty == t_y))[:, None, None]
            out = torch.where(sel, qpel_block_at(win, t_x, t_y), out)
    return out.reshape(n, 16, 8, 8)


def mc_luma_quads(planes, mv_quad, mb_xy, sr: int, y0: int = -PAD):
    """Quadrant-granular luma MC: (N, 4, 2) qpel MVs -> (N, 16, 16)
    int32 prediction; y0 the picture row of the planes' row 0."""
    n = mv_quad.shape[0]
    dev = mv_quad.device
    off, width = band_geometry(sr)
    qx = on(QUAD_X, dev) * 8
    qy = on(QUAD_Y, dev) * 8
    xi, xf = mv_quad[..., 0] >> 2, mv_quad[..., 0] & 3
    yi, yf = mv_quad[..., 1] >> 2, mv_quad[..., 1] & 3
    mb_idx = (mb_xy[:, 0:1] // 16).expand(n, 4)
    r0 = mb_xy[:, 1:2] + qy[None] + yi - y0
    c0 = qx[None] + xi + off
    win = band_windows(planes, mb_idx.reshape(-1), r0.reshape(-1),
                       c0.reshape(-1), 9, 9, 16, off, width)
    xf = xf.reshape(-1)
    yf = yf.reshape(-1)
    out = None
    for fy in range(4):
        for fx in range(4):
            p1, dx1, dy1, p2, dx2, dy2 = QPEL_TAB[(fx, fy)]
            a = win[:, p1, dy1:dy1 + 8, dx1:dx1 + 8]
            blk = a if p2 < 0 else \
                (a + win[:, p2, dy2:dy2 + 8, dx2:dx2 + 8] + 1) >> 1
            m = ((xf == fx) & (yf == fy))[:, None, None]
            out = blk if out is None else torch.where(m, blk, out)
    return out.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4).reshape(n, 16, 16)


def mc_chroma_quads(padU, padV, mv_quad, mb_xy, sr: int, y0c: int = -PAD):
    """Quadrant-granular chroma MC (eighth-pel bilinear, one 4x4 chroma
    block per 8x8 luma quadrant); y0c the chroma picture row of the
    planes' row 0. Returns (predU, predV) (N, 8, 8) int32."""
    n = mv_quad.shape[0]
    dev = mv_quad.device
    off, width = cband_geometry(sr)
    qx = on(QUAD_X, dev) * 4
    qy = on(QUAD_Y, dev) * 4
    x8 = qx[None] * 8 + mv_quad[..., 0]
    y8 = qy[None] * 8 + mv_quad[..., 1]
    xi, xf = x8 >> 3, x8 & 7
    yi, yf = y8 >> 3, y8 & 7
    mb_idx = (mb_xy[:, 0:1] // 16).expand(n, 4)
    r0 = mb_xy[:, 1:2] // 2 + yi - y0c
    c0 = xi + off
    win = band_windows(torch.stack([padU, padV]), mb_idx.reshape(-1),
                       r0.reshape(-1), c0.reshape(-1), 5, 5, 8, off, width)
    a = win[:, :, :4, :4]
    b = win[:, :, :4, 1:]
    c = win[:, :, 1:, :4]
    d = win[:, :, 1:, 1:]
    xfq = xf.reshape(-1)[:, None, None, None]
    yfq = yf.reshape(-1)[:, None, None, None]
    blk = ((8 - xfq) * (8 - yfq) * a + xfq * (8 - yfq) * b
           + (8 - xfq) * yfq * c + xfq * yfq * d + 32) >> 6    # (N4,2,4,4)
    uv = blk.reshape(n, 2, 2, 2, 4, 4).permute(0, 3, 1, 4, 2, 5) \
        .reshape(n, 2, 8, 8)
    return uv[:, 0], uv[:, 1]


def skip_cost(planes, skip_mv, mb_xy, orig_q, sr: int, y0: int = -PAD):
    """SAD of each MB predicted at its (approximate) skip MV. (N,)."""
    n = skip_mv.shape[0]
    pred16 = mc_luma_quads(planes, skip_mv[:, None, :].expand(n, 4, 2),
                           mb_xy, sr, y0)
    o = orig_q.to(I32).reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)
    return torch.abs(o - pred16).sum(dim=(1, 2))


# ---------------------------------------------------------------------------
# the P frame
# ---------------------------------------------------------------------------

def p_frame_step(origY, origU, origV, planes, padU, padV, qp: int, qpc: int,
                 lam: int, lam4: int, *, mb_w: int, mb_h: int, sr: int,
                 rd: bool = False):
    """Whole-picture encode of a P picture against one reference (twin of
    enc_jax.p_frame_step). rd=True decides the modes by the trial-encode
    RD of ops/enc_rd.py; rd=False by md_low's costs: the cheapest of the
    four partition modes' SATD costs, replaced by the approximate skip MV
    where its SAD is no larger. Returns the committed fields: inter_mode
    (N,), mv4 (N, 16, 2), luma_scan (N, 16, 16) int16, luma_nnz (N, 16),
    cbp (N,), chroma_dc (N, 2, 4) int16, chroma_scan (N, 2, 4, 16) int16,
    chroma_nnz (N, 2, 4), intra_mask (N,) bool and the recon planes
    recY / recU / recV uint8; int32 unless stated."""
    band_geometry(sr)           # sr above 16 raises first, as in jm_tpu
    int_mv, _ = me_int_sweep(origY, planes[0], mb_w, mb_h, sr, lam)
    return p_step_after_sweep(origY, origU, origV, planes, padU, padV,
                              int_mv, qp, qpc, lam, lam4, mb_w=mb_w,
                              mb_h=mb_h, sr=sr, rd=rd)


def p_step_after_sweep(origY, origU, origV, planes, padU, padV, int_mv,
                       qp: int, qpc: int, lam: int, lam4: int, *,
                       mb_w: int, mb_h: int, sr: int, rd: bool = False,
                       band_y0: int = 0, y0: int = -PAD, y0c: int = -PAD,
                       up_mv=None, src_up=None, is_first: bool = True):
    """p_frame_step after its integer sweep (int_mv (N, 9, 2)). md_low
    also runs it over an MB-row band of mb_h MB rows
    (parallel/sp_pipeline.py): the band's first row is picture row
    band_y0, the band's planes start at picture row y0 (chroma y0c), and
    up_mv / src_up are the integer 16x16 MVs and the source row of the
    row above it (is_first: the band holds the picture's first row)."""
    from .enc_rd import p_mode_rd_device
    n = mb_w * mb_h
    dev = origY.device
    ar = torch.arange(n, device=dev)
    mb_xy = torch.stack([(ar % mb_w) * 16, band_y0 + (ar // mb_w) * 16],
                        dim=1)
    orig_mbs = mb_tiles(origY, mb_h, mb_w, 16)
    orig_q = orig_mbs.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4) \
        .reshape(n, 4, 8, 8).to(I32)

    pred = approx_pred_field(int_mv[:, 0], mb_w, mb_h, up_mv, is_first)
    mv_q, cost_q, win = qpel_refine_dense(planes, orig_q, int_mv, pred,
                                          lam, mb_xy, sr, y0)
    mode_costs = torch.stack(
        [cost_q[:, jobs[0]:jobs[-1] + 1].sum(dim=1) + lam * int(MODE_BITS[m])
         for m, jobs in enumerate(MODE_JOBS)], dim=1).to(I32)   # (N, 4)
    cost_inter = torch.min(mode_costs, dim=1).values
    cost_skip = skip_cost(planes, pred, mb_xy, orig_q, sr, y0)
    take_skip = cost_skip <= cost_inter
    cost_inter = torch.minimum(cost_inter, cost_skip)
    intra_mask = i16_source_cost(origY, mb_w, mb_h, src_up, is_first) \
        + 2 * lam4 < cost_inter

    orig_u = mb_tiles(origU, mb_h, mb_w, 8)
    orig_v = mb_tiles(origV, mb_h, mb_w, 8)
    if rd:
        r = p_mode_rd_device(planes, padU, padV, win, mv_q, int_mv, pred,
                             orig_q, orig_u, orig_v, mb_xy, qp, qpc,
                             mb_w=mb_w, mb_h=mb_h, sr=sr,
                             mode_satd=mode_costs, top_modes=2)
        inter_mode, mv_quad = r["inter_mode"], r["mv_quad"]
        scan, nnz, cbp = r["luma_scan"], r["luma_nnz"], r["cbp"]
        cdc, cac, cnnz = r["chroma_dc"], r["chroma_scan"], r["chroma_nnz"]
        recY, recU, recV = r["recY_mbs"], r["recU_mbs"], r["recV_mbs"]
    else:
        # one MV per 8x8 quadrant, the decision granularity of the 9 jobs
        best_mode = torch.argmin(mode_costs, dim=1)
        quad_job = on(QUAD_JOB, dev)[best_mode]                # (N, 4)
        mv_quad = torch.gather(mv_q, 1, quad_job[..., None].expand(n, 4, 2))
        mv_quad = torch.where(take_skip[:, None, None],
                              pred[:, None, :].expand(n, 4, 2), mv_quad)
        inter_mode = torch.where(take_skip, 0, best_mode)
        scan, nnz, cbp_l, recY = luma_residual_inter(
            orig_mbs, mc_luma_quads(planes, mv_quad, mb_xy, sr, y0), qp)
        pu, pv = mc_chroma_quads(padU, padV, mv_quad, mb_xy, sr, y0c)
        cdc, cac, cnnz, cbp_c, recU, recV = chroma_residual(
            orig_u, orig_v, pu, pv, qpc, False)
        cbp = (cbp_c << 4) | cbp_l
    return {
        "inter_mode": inter_mode.to(I32),
        "mv4": mv_quad[:, on(BLK_QUAD, dev)].to(I32),
        "luma_scan": scan.to(torch.int16),
        "luma_nnz": nnz.to(I32),
        "cbp": cbp.to(I32),
        "chroma_dc": cdc.to(torch.int16),
        "chroma_scan": cac.to(torch.int16),
        "chroma_nnz": cnnz.to(I32),
        "intra_mask": intra_mask,
        "recY": mb_untile(recY, mb_h, mb_w, 16),
        "recU": mb_untile(recU, mb_h, mb_w, 8),
        "recV": mb_untile(recV, mb_h, mb_w, 8),
    }


def p_frame_bs(luma_nnz, mv4, *, mb_w: int, mb_h: int):
    """Boundary strengths of an all-inter P picture against one reference
    (twin of enc_jax.p_frame_bs): (bs_v, bs_h) int8."""
    from .deblock import compute_bs
    n = mb_w * mb_h
    dev = luma_nnz.device
    zeros = torch.zeros(n, dtype=I32, device=dev)
    return compute_bs(zeros, luma_nnz, zeros, mv4, torch.zeros_like(mv4),
                      torch.full((n, 4), 7, dtype=I32, device=dev),
                      torch.full((n, 4), -1, dtype=I32, device=dev),
                      mb_w, mb_h)


def p_frame_rd_pipe(packed_in, planes, padU, padV, qp: int, qpc: int,
                    lam: int, lam4: int, qpc_cb_tab, qpc_cr_tab, *,
                    mb_w: int, mb_h: int, sr: int, max_words: int,
                    rd: bool = True):
    """One P frame end to end: encode (p_frame_step, RD or md_low) ->
    boundary strengths -> deblock -> next-reference prep -> CAVLC slice
    pack (twin of enc_jax.p_frame_rd_pipe, and for rd=False of the same
    stages as encoder.encode_stream composes them for md_low).

    packed_in: (24 mb_h, 16 mb_w) uint8, Y on top, U|V side by side below.
    Returns (out, state): out["words_ext"] (3 + max_words,) int64 holds
    [nbits, ovf, intra_any] then the packed 32-bit words (each masked to
    32 bits); out["core"] the p_frame_step fields; out["skip"] (N,) bool.
    state is the deblocked picture as prep_ref output."""
    from . import cavlc as CV
    from .deblock import deblock
    h, w = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    dev = packed_in.device
    origY = packed_in[:h]
    origU = packed_in[h:, :w // 2]
    origV = packed_in[h:, w // 2:]
    core = p_frame_step(origY, origU, origV, planes, padU, padV, qp, qpc,
                        lam, lam4, mb_w=mb_w, mb_h=mb_h, sr=sr, rd=rd)
    bs_v, bs_h = p_frame_bs(core["luma_nnz"], core["mv4"], mb_w=mb_w,
                            mb_h=mb_h)
    zeros = torch.zeros(n, dtype=I32, device=dev)
    qp_arr = torch.full((n,), qp, dtype=I32, device=dev)
    dY, dU, dV = deblock(core["recY"], core["recU"], core["recV"], bs_v,
                         bs_h, qp_arr, zeros, zeros, zeros, zeros, zeros,
                         qpc_cb_tab, qpc_cr_tab, mb_w=mb_w, mb_h=mb_h)
    state = prep_ref(dY, dU, dV)
    packed = CV.pack_p_slice_full(
        core["inter_mode"], core["mv4"], core["cbp"], core["luma_scan"],
        core["luma_nnz"], core["chroma_dc"], core["chroma_scan"],
        core["chroma_nnz"], mb_w=mb_w, mb_h=mb_h, max_words=max_words)
    flags = torch.stack([packed["nbits"].to(torch.int64),
                         packed["ovf"].to(torch.int64),
                         core["intra_mask"].any().to(torch.int64)])
    words_ext = torch.cat([flags, packed["words"]])
    return {"words_ext": words_ext, "core": core,
            "skip": packed["skip"]}, state
