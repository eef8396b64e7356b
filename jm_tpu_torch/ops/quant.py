"""Bit-exact 4x4 quantization / dequantization on int32 tensors and the
8x8 dequantization (twin of the decoder half of jm_tpu/ops/quant.py).

Decoder-side scaling follows spec 8.5.10-8.5.12; encoder-side forward
quant is JM's "normal" strategy (lencod/src/quant4x4_normal.c:
level = (|W|*MF + f) >> qbits with deadzone f = 2^qbits/3 intra, /6
inter). ``qp`` arguments are int32 tensors broadcastable to the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import tables as T
from .consts import on


def _expand_dequant_4x4(weight_scale: np.ndarray) -> np.ndarray:
    """(52, 4, 4) int32: InvLevelScale = V[qp%6] * weightScale."""
    ws = np.asarray(weight_scale, dtype=np.int64).reshape(4, 4)
    out = np.zeros((52, 4, 4), dtype=np.int64)
    for qp in range(52):
        out[qp] = T.DEQUANT_SCALE_4x4[qp % 6] * ws
    return out.astype(np.int32)


# flat-list table (no scaling matrices)
FLAT_INV_SCALE_4x4 = _expand_dequant_4x4(np.full((4, 4), 16))
QUANT_SCALE_4x4 = np.asarray(T.QUANT_SCALE_4x4, np.int32)


def rshift_rnd_sf(x: torch.Tensor, a: int) -> torch.Tensor:
    """Rounded right shift (x + (1 << (a-1))) >> a, for a >= 1."""
    return (x + (1 << (a - 1))) >> a


def dequant_4x4(coef: torch.Tensor, qp: torch.Tensor,
                tab: torch.Tensor | None = None,
                dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """coef (..., 4, 4) levels, qp (...,) int32 -> scaled coefficients
    d = rshift_rnd_sf((c * InvScale[qp]) << (qp/6), 4) in ``dtype``
    (int64 for the QP' of >8-bit pictures); tab: a (52, 4, 4) or
    (88, 4, 4) int32 InvLevelScale table on coef's device (flat lists by
    default)."""
    qp = qp.to(torch.int32)
    if tab is None:
        tab = on(FLAT_INV_SCALE_4x4, coef.device)
    scale = tab[qp.long()].to(dtype)
    per = (qp // 6)[..., None, None]
    return rshift_rnd_sf((coef.to(dtype) * scale) << per, 4)


def dequant_8x8(coef: torch.Tensor, qp: torch.Tensor,
                tab: torch.Tensor) -> torch.Tensor:
    """coef (..., 8, 8) levels, qp (...,) -> scaled coefficients (spec
    8.5.13.1) d = rshift_rnd_sf((c * LevelScale8[qp]) << (qp/6), 6), which
    is the left shift by qp/6 - 6 for qp >= 36 and the rounded right shift
    by 6 - qp/6 below; tab: a (52, 8, 8) LevelScale8 table on coef's
    device. In int64, so that any level is exact."""
    qp = qp.to(torch.int64)
    scale = tab[qp].to(torch.int64)
    per = (qp // 6)[..., None, None]
    return rshift_rnd_sf((coef.to(torch.int64) * scale) << per, 6)


def dequant_chroma_dc(dc: torch.Tensor, qp: torch.Tensor,
                      tab: torch.Tensor) -> torch.Tensor:
    """Chroma DC scaling after the 2x2 Hadamard (spec 8.5.11.2):
    ((f * InvScale[qp][0, 0]) << (qp/6)) >> 5, floor; qp (B,) against dc
    (B, ...), tab (52 or 88, 4, 4) int32; in int64 when dc is int64,
    else int32."""
    qp = qp.to(torch.int32)
    dt = torch.int64 if dc.dtype == torch.int64 else torch.int32
    scale = tab[qp.long(), 0, 0].to(dt)
    per = qp // 6
    while scale.dim() < dc.dim():
        scale = scale[..., None]
        per = per[..., None]
    return ((dc.to(dt) * scale) << per) >> 5


def dc_scale(qp: torch.Tensor) -> torch.Tensor:
    """InvScale[qp][0, 0] (int32), the DC dequant factor."""
    return on(FLAT_INV_SCALE_4x4, qp.device)[qp.long(), 0, 0]


def quant_4x4(w: torch.Tensor, qp: torch.Tensor, intra: bool) -> torch.Tensor:
    """level = sign(w) * ((|w| * MF[qp%6] + f) >> qbits), qbits = 15 +
    qp/6; w (..., 4, 4), qp (...,) int32."""
    qp = qp.to(torch.int32)
    scale = on(QUANT_SCALE_4x4, w.device)[(qp % 6).long()]
    qbits = 15 + qp // 6
    f = ((1 << qbits) // (3 if intra else 6))[..., None, None]
    aw = torch.abs(w.to(torch.int32))
    lev = (aw * scale + f) >> qbits[..., None, None]
    return torch.sign(w).to(torch.int32) * lev


def quant_luma_dc(dc: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Intra16x16 DC after forward Hadamard: (|c|*MF00 + 2f) >> (qbits+1);
    dc (..., 4, 4), qp (...,)."""
    qp = qp.to(torch.int32)
    scale = on(QUANT_SCALE_4x4, dc.device)[(qp % 6).long(), 0, 0][..., None, None]
    qbits = 15 + qp // 6
    f = ((1 << qbits) // 3)[..., None, None]
    aw = torch.abs(dc.to(torch.int32))
    lev = (aw * scale + 2 * f) >> (qbits[..., None, None] + 1)
    return torch.sign(dc).to(torch.int32) * lev


def quant_chroma_dc(dc: torch.Tensor, qp: torch.Tensor,
                    intra: bool) -> torch.Tensor:
    """Chroma DC after Hadamard: (|c|*MF00 + 2f) >> (qbits+1); qp is
    broadcast against dc after right-padding its dims."""
    qp = qp.to(torch.int32)
    scale = on(QUANT_SCALE_4x4, dc.device)[(qp % 6).long(), 0, 0]
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    while scale.dim() < dc.dim():
        scale = scale[..., None]
        qbits = qbits[..., None]
        f = f[..., None]
    aw = torch.abs(dc.to(torch.int32))
    lev = (aw * scale + 2 * f) >> (qbits + 1)
    return torch.sign(dc).to(torch.int32) * lev
