"""Bit-exact H.264 integer transforms on int32 tensors, batched over
leading dims (twin of jm_tpu/ops/transform.py, 4x4 subset).

Trailing two dims are the block: (..., 4, 4) / (..., 2, 2). "Rows" are
the last-but-one axis (vertical index j), "cols" the last axis, matching
the spec's d[j][i] (ISO/IEC 14496-10 8.5.10-8.5.12).
"""

from __future__ import annotations

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


def forward4x4(x: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 core transform W = Cf X Cf^T (no scaling); int32."""
    x = x.to(torch.int32)
    t = torch.stack(_fwd4_1d(*_rows(x)), dim=-2)          # vertical pass
    return torch.stack(_fwd4_1d(*_cols(t)), dim=-1)       # horizontal


def _inv4_1d(d0, d1, d2, d3):
    """One 1-D stage of the inverse core transform (spec 8.5.12.2)."""
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def inverse4x4(x: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 core transform WITHOUT the final (r+32)>>6 rounding."""
    x = x.to(torch.int32)
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
