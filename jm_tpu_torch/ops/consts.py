"""Device copies of constant numpy tables, and the quarter-pel layout of
a reference picture (PAD, QPEL_TAB) shared by the encoder's motion
search and the decoder's inter prediction.

Every table the tensor stages index (quant scales, CAVLC code tables,
deblock thresholds, ...) is a module-level numpy array; ``on(table,
device)`` returns its torch twin on ``device``, made once per (table,
device). Callers must not write to the returned tensor."""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def on(table: np.ndarray, device) -> torch.Tensor:
    """The torch copy of constant ``table`` on ``device`` (dtype kept:
    int32 tables stay int32)."""
    key = (id(table), str(torch.device(device)))
    t = _CACHE.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(table), device=device)
        _CACHE[key] = (t, table)          # keep the array alive: id() key
        return t
    return t[0]


PAD = 32      # replicated reference padding (jm_tpu/ops/interp.py PAD)


def plane_dtype(bd) -> torch.dtype:
    """The dtype of a picture's device planes at bit depths bd = (luma,
    chroma): uint8 at 8 bits, int16 when either is above 8. int16 holds
    every sample up to 14 bits exactly and, unlike torch's uint16, has
    the CUDA ops the stages use (arithmetic, indexing, cat, clamp); host
    planes of such pictures are numpy uint16, as in jm_tpu."""
    return torch.uint8 if max(bd) == 8 else torch.int16

# quarter-pel selection (interp.QPEL_TAB): (xf, yf) -> (plane1, dx1, dy1,
# plane2, dx2, dy2); planes 0=INT, 1=B (half-h), 2=H (half-v), 3=J
QPEL_TAB = {
    (0, 0): (0, 0, 0, -1, 0, 0),
    (2, 0): (1, 0, 0, -1, 0, 0),
    (0, 2): (2, 0, 0, -1, 0, 0),
    (2, 2): (3, 0, 0, -1, 0, 0),
    (1, 0): (0, 0, 0, 1, 0, 0),
    (3, 0): (0, 1, 0, 1, 0, 0),
    (0, 1): (0, 0, 0, 2, 0, 0),
    (0, 3): (0, 0, 1, 2, 0, 0),
    (2, 1): (1, 0, 0, 3, 0, 0),
    (2, 3): (1, 0, 1, 3, 0, 0),
    (1, 2): (2, 0, 0, 3, 0, 0),
    (3, 2): (2, 1, 0, 3, 0, 0),
    (1, 1): (1, 0, 0, 2, 0, 0),
    (3, 1): (1, 0, 0, 2, 1, 0),
    (1, 3): (1, 0, 1, 2, 0, 0),
    (3, 3): (1, 0, 1, 2, 1, 0),
}
