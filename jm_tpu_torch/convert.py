"""State carried into the port from outside it.

A codec has no weights: its state is the reference picture (the
quarter-pel planes and padded chroma of the last decoded frame) and the
QP tables. These helpers take that state as numpy arrays (for example
jm_tpu's ``enc_jax.prep_ref`` output) and return the port's tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .common.tables import chroma_qp


def ref_state_from_numpy(planes, padU, padV, device="cpu"):
    """(planes (4, H+2P, W+2P), padU, padV) uint8 arrays -> the same
    reference state as uint8 tensors on ``device``."""
    return tuple(torch.as_tensor(np.array(a, np.uint8), device=device)
                 for a in (planes, padU, padV))


def qpc_tables(pps, device="cpu"):
    """(qpc_cb, qpc_cr): (52,) int32 luma QP -> chroma QP tables of the
    PPS's Cb / Cr offsets (spec Table 8-15)."""
    cb = [chroma_qp(q, pps.cb_qp_offset) for q in range(52)]
    cr = [chroma_qp(q, pps.cr_qp_offset) for q in range(52)]
    return (torch.tensor(cb, dtype=torch.int32, device=device),
            torch.tensor(cr, dtype=torch.int32, device=device))
