"""Distortion metrics: PSNR, SSIM, MS-SSIM (numpy; the port's own copy of
jm_tpu/metrics.py).

Behavioral parity with the reference implementations:
  - PSNR/SSE: lencod/src/img_dist_snr.c:30 (find_snr), decoder twin
    ldecod/src/image.c:1132.
  - SSIM: lencod/src/img_dist_ssim.c:23 (compute_ssim) — 8x8 windows for
    luma (chroma-MB-sized windows for chroma), integer moment sums, biased
    variance, stride = SSIMOverlapSize.
  - MS-SSIM: lencod/src/img_dist_ms_ssim.c:279 (compute_ms_ssim) — 5 scales,
    structural component at all scales, luminance only at the coarsest,
    exponents beta0..beta4, dyadic downsample with the [1 3 28 28 3 1]/64
    low-pass and symmetric edge extension.

Redesigned as batched tensor ops (stride-windowed sums over whole frames)
rather than the reference's per-window scalar loops.
"""

from __future__ import annotations

import numpy as np

_K1, _K2 = 0.01, 0.03
_MS_SSIM_EXP = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def sse(ref: np.ndarray, enc: np.ndarray) -> float:
    d = ref.astype(np.int64) - enc.astype(np.int64)
    return float((d * d).sum())


def psnr(ref: np.ndarray, enc: np.ndarray, max_value: int = 255) -> float:
    """PSNR as in img_dist_snr.c (10*log10(max^2 * N / SSE); 99.99 cap for
    identical frames like the reference report)."""
    s = sse(ref, enc)
    if s == 0:
        return 99.99
    return float(10.0 * np.log10(max_value * max_value *
                                 (ref.size / s)))


def _window_sums(img: np.ndarray, wh: int, ww: int, stride: int):
    """Sum of each wh x ww window at the JM grid (j/i from 0, step stride,
    while window fits). Returns (n_wy, n_wx) float64 via integral image."""
    H, W = img.shape
    ii = np.zeros((H + 1, W + 1), np.int64)
    np.cumsum(np.cumsum(img, axis=0, dtype=np.int64), axis=1, out=ii[1:, 1:])
    ys = np.arange(0, H - wh + 1, stride)
    xs = np.arange(0, W - ww + 1, stride)
    a = ii[np.ix_(ys, xs)]
    b = ii[np.ix_(ys, xs + ww)]
    c = ii[np.ix_(ys + wh, xs)]
    d = ii[np.ix_(ys + wh, xs + ww)]
    return (d - b - c + a).astype(np.float64)


def _moments(ref, enc, wh, ww, stride):
    r = ref.astype(np.int64)
    e = enc.astype(np.int64)
    m_r = _window_sums(r, wh, ww, stride)
    m_e = _window_sums(e, wh, ww, stride)
    v_r = _window_sums(r * r, wh, ww, stride)
    v_e = _window_sums(e * e, wh, ww, stride)
    cov = _window_sums(r * e, wh, ww, stride)
    return m_r, m_e, v_r, v_e, cov


def ssim(ref: np.ndarray, enc: np.ndarray, win: tuple[int, int] = (8, 8),
         overlap: int = 8, max_value: int = 255) -> float:
    """compute_ssim parity (biased variance, float32 accumulation order is
    immaterial at these magnitudes; 1.0 clamp for >=1 results)."""
    wh, ww = win
    wh, ww = min(wh, ref.shape[0]), min(ww, ref.shape[1])
    n = float(wh * ww)
    c1 = _K1 * _K1 * max_value * max_value
    c2 = _K2 * _K2 * max_value * max_value
    s_r, s_e, ss_r, ss_e, s_re = _moments(ref, enc, wh, ww, overlap)
    mu_r, mu_e = s_r / n, s_e / n
    var_r = (ss_r - s_r * mu_r) / n
    var_e = (ss_e - s_e * mu_e) / n
    cov = (s_re - s_r * mu_e) / n
    val = ((2.0 * mu_r * mu_e + c1) * (2.0 * cov + c2)) / \
        ((mu_r * mu_r + mu_e * mu_e + c1) * (var_r + var_e + c2))
    out = float(val.mean())
    return 1.0 if 1.0 <= out < 1.01 else out


def _structural(ref, enc, wh, ww, overlap, max_value):
    n = float(wh * ww)
    c2 = _K2 * _K2 * max_value * max_value
    s_r, s_e, ss_r, ss_e, s_re = _moments(ref, enc, wh, ww, overlap)
    mu_r, mu_e = s_r / n, s_e / n
    var_r = (ss_r - s_r * mu_r) / n
    var_e = (ss_e - s_e * mu_e) / n
    cov = (s_re - s_r * mu_e) / n
    val = (2.0 * cov + c2) / (var_r + var_e + c2)
    out = float(val.mean())
    return 1.0 if 1.0 <= out < 1.01 else out


def _luminance(ref, enc, wh, ww, overlap, max_value):
    n = float(wh * ww)
    c1 = _K1 * _K1 * max_value * max_value
    s_r = _window_sums(ref.astype(np.int64), wh, ww, overlap) / n
    s_e = _window_sums(enc.astype(np.int64), wh, ww, overlap) / n
    val = (2.0 * s_r * s_e + c1) / (s_r * s_r + s_e * s_e + c1)
    out = float(val.mean())
    return 1.0 if 1.0 <= out < 1.01 else out


def _downsample(img: np.ndarray) -> np.ndarray:
    """Dyadic low-pass decimation of img_dist_ms_ssim.c:225 (downsample):
    [1 3 28 28 3 1]/64 separable, symmetric (non-edge-repeating) extension,
    horizontal then vertical, floor shifts, uint8 wrap as in the reference
    (byte store without clipping)."""
    H, W = img.shape
    h2, w2 = H >> 1, W >> 1
    x = img.astype(np.int64)
    # horizontal: pad 2 left / 3 right by mirror-without-repeat
    xp = np.concatenate([x[:, 2:0:-1], x, x[:, W - 2:W - 5:-1]], axis=1)
    ii = 2 + 2 * np.arange(w2)
    t1 = xp[:, ii - 1] + xp[:, ii + 2]
    t2 = xp[:, ii] + xp[:, ii + 1]
    hor = (xp[:, ii - 2] + xp[:, ii + 3] + 3 * t1 + 28 * t2) >> 6
    # vertical on the horizontally filtered full-height array
    vp = np.concatenate([hor[2:0:-1], hor, hor[H - 2:H - 5:-1]], axis=0)
    jj = 2 + 2 * np.arange(h2)
    t1 = vp[jj - 1] + vp[jj + 2]
    t2 = vp[jj] + vp[jj + 1]
    out = (vp[jj - 2] + vp[jj + 3] + 3 * t1 + 28 * t2) >> 6
    return out.astype(np.uint8)  # byte store (reference casts w/o clip)


def ms_ssim(ref: np.ndarray, enc: np.ndarray, win: tuple[int, int] = (8, 8),
            overlap: int = 8, max_value: int = 255) -> float:
    """compute_ms_ssim parity: 5 dyadic scales; structural term at each,
    luminance term only at the coarsest; exponents MS_SSIM_BETA0..4."""
    wh, ww = win
    r, e = ref, enc
    h, w = r.shape
    val = _structural(r, e, min(wh, h), min(ww, w), overlap, max_value) \
        ** _MS_SSIM_EXP[0]
    r, e = _downsample(r), _downsample(e)
    for m in range(1, 5):
        h, w = r.shape
        s = _structural(r, e, min(wh, h), min(ww, w), overlap, max_value)
        val *= s ** _MS_SSIM_EXP[m]
        if m < 4:
            r, e = _downsample(r), _downsample(e)
        else:
            lum = _luminance(r, e, min(wh, h), min(ww, w), overlap, max_value)
            val *= lum ** _MS_SSIM_EXP[m]
    return float(val)
