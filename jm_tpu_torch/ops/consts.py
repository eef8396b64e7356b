"""Device copies of constant numpy tables.

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
