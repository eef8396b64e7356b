"""Loss-aware RD of rdo tier 3 (md_highloss): the decoder-in-encoder
ensemble, twin of jm_tpu/encoder/errdo.py (lencod errdo.c, LossRateA /
NumberOfDecoders). K error planes stand for K simulated decoders (each
the luma of a lossy decoder's recon minus the clean recon). An inter MB
inherits the error at its integer MV, an intra MB resets it, and a
picture lost by decoder k (probability LossRateA %, from the seeded
generator) adds the frame-difference error of frame-copy concealment.
The RD loop adds the mean error energy an inter candidate would inherit
to its distortion.
"""

from __future__ import annotations

import numpy as np

from ..common.picture import MB_INTER


class ErrdoState:
    """num_decoders error planes of an h x w luma picture, loss_rate the
    percentage of pictures each decoder loses."""

    def __init__(self, num_decoders: int, loss_rate: int, h: int, w: int,
                 seed: int = 13):
        self.k = num_decoders
        self.loss = loss_rate
        self.err = np.zeros((num_decoders, h, w), np.int32)
        self.rng = np.random.default_rng(seed)
        self.h, self.w = h, w
        self._prev_recon = None

    def mb_error_energy(self, pic, addr: int, mb_w: int) -> float:
        """The mean error SSD, over the decoders, that MB addr of pic
        inherits when it is inter (each 4x4 block sampled at its
        integer-rounded MV); 0 for an intra MB."""
        if self.k == 0 or pic.mb_class[addr] != MB_INTER:
            return 0.0
        px, py = (addr % mb_w) * 16, (addr // mb_w) * 16
        total = 0.0
        for blk in range(16):
            by, bx = divmod(blk, 4)
            x = min(max(px + bx * 4 + (int(pic.mv[addr, blk, 0]) >> 2), 0),
                    self.w - 4)
            y = min(max(py + by * 4 + (int(pic.mv[addr, blk, 1]) >> 2), 0),
                    self.h - 4)
            e = self.err[:, y:y + 4, x:x + 4].astype(np.int64)
            total += float((e * e).sum())
        return total / max(self.k, 1)

    def update(self, pic, recY: np.ndarray, mb_w: int, is_ref: bool) -> None:
        """Advance every decoder past a coded picture (pic, its deblocked
        luma recY)."""
        if self.k == 0:
            return
        new_err = np.zeros_like(self.err)
        for addr in range(pic.n_mbs):
            if pic.mb_class[addr] != MB_INTER:
                continue                       # intra resets the drift
            px, py = (addr % mb_w) * 16, (addr // mb_w) * 16
            for blk in range(16):
                by, bx = divmod(blk, 4)
                x = min(max(px + bx * 4 + (int(pic.mv[addr, blk, 0]) >> 2),
                            0), self.w - 4)
                y = min(max(py + by * 4 + (int(pic.mv[addr, blk, 1]) >> 2),
                            0), self.h - 4)
                new_err[:, py + by * 4:py + by * 4 + 4,
                        px + bx * 4:px + bx * 4 + 4] = \
                    self.err[:, y:y + 4, x:x + 4]
        # each decoder's channel: a lost picture is concealed by a copy of
        # the previous one
        lost = self.rng.random(self.k) * 100.0 < self.loss
        if self._prev_recon is not None:
            diff = self._prev_recon.astype(np.int32) - recY.astype(np.int32)
            for k in np.flatnonzero(lost):
                new_err[k] = self.err[k] + diff
        if is_ref:
            self.err = new_err
        self._prev_recon = recY.astype(np.int32)
