"""Bit-exact H.264 integer transforms on int32 tensors, batched over
leading dims (twin of jm_tpu/ops/transform.py: the 4x4 core transform,
the Hadamards and the 8x8 inverse; the 1-D 8x8 stages also take numpy
arrays, so the host coders' forward 8x8 and the decoder's numpy inverse
are the same code).

Trailing two dims are the block: (..., 4, 4) / (..., 2, 2) / (..., 8, 8). "Rows" are
the last-but-one axis (vertical index j), "cols" the last axis, matching
the spec's d[j][i] (ISO/IEC 14496-10 8.5.10-8.5.12).
"""

from __future__ import annotations

import numpy as np
import torch


def _rows(x):
    return x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]


def _cols(x):
    return x[..., :, 0], x[..., :, 1], x[..., :, 2], x[..., :, 3]


def _fwd4_1d(d0, d1, d2, d3):
    """One 1-D stage of the forward core transform (factors 1,2,1,1)."""
    p0, p1 = d0 + d3, d1 + d2
    m0, m1 = d0 - d3, d1 - d2
    return p0 + p1, 2 * m0 + m1, p0 - p1, m0 - 2 * m1


def forward4x4(x: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Forward 4x4 core transform W = Cf X Cf^T (no scaling), in dtype."""
    x = x.to(dtype)
    t = torch.stack(_fwd4_1d(*_rows(x)), dim=-2)          # vertical pass
    return torch.stack(_fwd4_1d(*_cols(t)), dim=-1)       # horizontal


def _inv4_1d(d0, d1, d2, d3):
    """One 1-D stage of the inverse core transform (spec 8.5.12.2)."""
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def inverse4x4(x: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Inverse 4x4 core transform WITHOUT the final (r+32)>>6 rounding, in
    dtype."""
    x = x.to(dtype)
    t = torch.stack(_inv4_1d(*_cols(x)), dim=-1)          # horizontal
    return torch.stack(_inv4_1d(*_rows(t)), dim=-2)       # vertical


def inverse4x4_round(x: torch.Tensor) -> torch.Tensor:
    """Full inverse transform with normative rounding r = (f + 32) >> 6."""
    return (inverse4x4(x) + 32) >> 6


def _had4_1d(d0, d1, d2, d3):
    p0, p1 = d0 + d3, d1 + d2
    m0, m1 = d0 - d3, d1 - d2
    return p0 + p1, m0 + m1, p0 - p1, m0 - m1


def hadamard4x4(x: torch.Tensor) -> torch.Tensor:
    """4x4 Hadamard butterfly (Intra16x16 luma DC), both directions."""
    x = x.to(torch.int32)
    t = torch.stack(_had4_1d(*_rows(x)), dim=-2)
    return torch.stack(_had4_1d(*_cols(t)), dim=-1)


def hadamard2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 Hadamard for chroma DC (4:2:0)."""
    x = x.to(torch.int32)
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    r0 = torch.stack([a + b + c + d, a - b + c - d], dim=-1)
    r1 = torch.stack([a + b - c - d, a - b - c + d], dim=-1)
    return torch.stack([r0, r1], dim=-2)


def fwd8_1d(d):
    """One 1-D stage of the forward 8x8 transform (lencod transform8x8.c
    forward8x8); d: 8 arrays or tensors. Returns the 8 outputs."""
    a0, a1, a2, a3 = d[0] + d[7], d[1] + d[6], d[2] + d[5], d[3] + d[4]
    a4, a5, a6, a7 = d[0] - d[7], d[1] - d[6], d[2] - d[5], d[3] - d[4]
    b0, b1, b2, b3 = a0 + a3, a1 + a2, a0 - a3, a1 - a2
    b4 = a5 + a6 + ((a4 >> 1) + a4)
    b5 = a4 - a7 - ((a6 >> 1) + a6)
    b6 = a4 + a7 - ((a5 >> 1) + a5)
    b7 = a5 - a6 + ((a7 >> 1) + a7)
    return (b0 + b1, b4 + (b7 >> 2), b2 + (b3 >> 1), b5 + (b6 >> 2),
            b0 - b1, b6 - (b5 >> 2), (b2 >> 1) - b3, -(b4 >> 2) + b7)


def inv8_1d(d):
    """One 1-D stage of the inverse 8x8 transform (spec 8.5.13.2); d: 8
    arrays or tensors. Returns the 8 outputs."""
    a0, a4 = d[0] + d[4], d[0] - d[4]
    a2, a6 = (d[2] >> 1) - d[6], d[2] + (d[6] >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    a3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    a5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    a7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    b1, b7 = a1 + (a7 >> 2), a7 - (a1 >> 2)
    b3, b5 = a3 + (a5 >> 2), (a3 >> 2) - a5
    return (b0 + b7, b2 + b5, b4 + b3, b6 + b1,
            b6 - b1, b4 - b3, b2 - b5, b0 - b7)


def inverse8x8_round(x: torch.Tensor) -> torch.Tensor:
    """Inverse 8x8 transform, rows then columns, with the normative
    rounding (f + 32) >> 6, in x's integer dtype."""
    t = torch.stack(inv8_1d(tuple(x[..., :, i] for i in range(8))), dim=-1)
    v = torch.stack(inv8_1d(tuple(t[..., j, :] for j in range(8))), dim=-2)
    return (v + 32) >> 6


def split_8x8(a):
    """(..., 4, 8, 8) quadrants -> (..., 16, 4, 4) raster 4x4 blocks, the
    layout of the 4x4 residuals; numpy arrays or tensors."""
    sh = a.shape[:-3]
    k = len(sh)
    perm = (*range(k), k, k + 2, k + 1, k + 4, k + 3, k + 5)
    a = a.reshape(*sh, 2, 2, 2, 4, 2, 4)
    a = a.transpose(perm) if isinstance(a, np.ndarray) else a.permute(perm)
    return a.reshape(*sh, 16, 4, 4)
