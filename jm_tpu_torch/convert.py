"""State carried into the port from outside it.

A codec has no weights: its state is the reference picture (the
quarter-pel planes and padded chroma of the last decoded frame), the QP
tables and a parsed picture's macroblock arrays. These helpers take that
state as numpy arrays (for example jm_tpu's ``enc_jax.prep_ref`` output
or its decoder's parsed ``PictureData``) and return the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from .common.picture import PictureData
from .common.tables import chroma_qp

# the macroblock arrays a parsed (or encoded) picture carries into
# reconstruction and the serializers
_PICTURE_FIELDS = (
    "mb_class", "skip", "transform8x8", "i4_modes", "i16_mode",
    "chroma_mode", "cbp", "qp", "slice_id", "luma_coef", "luma_dc",
    "luma_coef8", "chroma_dc", "chroma_coef", "luma_nnz", "chroma_nnz", "mv",
    "ref_idx", "mv_l1", "ref_idx_l1", "sub_mode", "inter_mode", "pdir",
    "b_direct", "b8_direct", "ref_pic_id", "ref_pic_id_l1", "mvd",
    "cbp_bits", "sp_mb", "sp_slice", "sp_qs", "sp_switch")


def ref_state_from_numpy(planes, padU, padV, device="cpu"):
    """(planes (4, H+2P, W+2P), padU, padV) uint8 arrays -> the same
    reference state as uint8 tensors on ``device``."""
    return tuple(torch.as_tensor(np.array(a, np.uint8), device=device)
                 for a in (planes, padU, padV))


def qpc_tables(pps, device="cpu", bd=(8, 8)):
    """(qpc_cb, qpc_cr): the luma QP -> chroma QP tables of the PPS's Cb /
    Cr offsets (spec 8.5.8, Table 8-15) at bit depths bd = (luma,
    chroma), (52 + QpBdOffsetY,) int32 each: entry QPY + QpBdOffsetY
    holds QPc (from -QpBdOffsetC to 51; jm_tpu/ops/deblock.py
    deblock_picture's tables from QPY -48). A caller indexes them with
    that offset, which the length gives: 8 bits, (52,), offset 0."""
    off = 6 * (bd[0] - 8)
    cb = [chroma_qp(q, pps.cb_qp_offset, bd[1]) for q in range(-off, 52)]
    cr = [chroma_qp(q, pps.cr_qp_offset, bd[1]) for q in range(-off, 52)]
    return (torch.tensor(cb, dtype=torch.int32, device=device),
            torch.tensor(cr, dtype=torch.int32, device=device))


def picture_from_numpy(src) -> PictureData:
    """A parsed 4:2:0 or 4:2:2 frame or field picture's SoA state, of any
    bit depth (any object with numpy arrays under PictureData's names and
    its field_mode, e.g. jm_tpu's decoder ``PictureData``) as the port's
    PictureData; arrays are copied."""
    pic = PictureData(src.mb_w, src.mb_h,
                      getattr(src, "chroma_format_idc", 1))
    for name in _PICTURE_FIELDS:
        dst = getattr(pic, name)
        a = np.asarray(getattr(src, name))
        if a.shape != dst.shape:
            raise ValueError(f"picture_from_numpy: {name} has shape "
                             f"{a.shape}, expected {dst.shape}")
        dst[...] = a
    pic.field_mode = bool(getattr(src, "field_mode", False))
    # I_PCM samples keep their dtype: uint8, or uint16 above 8 bits
    pic.ipcm_luma = {int(k): np.array(v) for k, v in src.ipcm_luma.items()}
    pic.ipcm_chroma = {int(k): np.array(v)
                       for k, v in src.ipcm_chroma.items()}
    return pic
