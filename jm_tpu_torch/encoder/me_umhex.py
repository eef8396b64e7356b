"""UMHexagonS integer-pel motion search, the port's numpy copy of
jm_tpu/encoder/me_umhex.py: UMHexSearcher (EncoderConfig.search_mode 1;
lencod me_umhex.c UMHEXIntegerPelBlockMotionSearch:266: the start
points, a small local diamond, early termination, the unsymmetrical
cross, the 5x5 window and the multi-big-hexagon rings, then the hexagon
and diamond until converged) and UMHexSmpSearcher (search_mode 2;
me_umhexsmp.c smpUMHEXIntegerPelBlockMotionSearch:232: the start points,
a small cross-diamond, then the hexagon and diamond). Both reuse
EPZSearcher's memoized SADs, predictors and cost, SAD + lambda * mvd
bits.
"""

from __future__ import annotations

import numpy as np

from .me_epzs import EPZSearcher, _blocktype, mv_bits

_DIAMOND = ((-1, 0), (0, -1), (1, 0), (0, 1))
# qpel tables of me_umhex.c:44-46 scaled to integer pel
_HEXAGON = ((-2, 0), (2, 0), (-1, -2), (1, 2), (-1, 2), (1, -2))
_BIG_HEX = ((0, 2), (-2, 3), (-4, 2), (-4, 1), (-4, 0), (-4, -1),
            (-4, -2), (-2, -3), (0, -4), (2, -3), (4, -2), (4, -1),
            (4, 0), (4, 1), (4, 2), (2, 3))
# 5x5 spiral (spiral_qpel_search positions 1..24 at integer pel)
_WIN5 = [(dx, dy) for dy in range(-2, 3) for dx in range(-2, 3)
         if (dx, dy) != (0, 0)]
# per-blocktype early-termination thresholds (me_umhex.c:49
# Big_Hexagon_Thd, indexed by JM blocktype 1..7)
_ET_THRED = {1: 3000, 2: 1500, 3: 1500, 4: 800, 5: 400, 6: 400, 7: 200}


class UMHexSearcher(EPZSearcher):
    """SearchMode 1: UMHexagonS."""

    def search(self, addr: int, r: int, quads, pred_mv,
               seed=None) -> np.ndarray:
        sr, lam = self.sr, self.lam
        quads = tuple(quads)
        bt = _blocktype(quads)
        et = _ET_THRED.get(bt, 800) * len(quads)

        def mcost(dx, dy):
            return (self._sad(addr, r, quads, dx, dy)
                    + lam * mv_bits(4 * dx - int(pred_mv[0]),
                                    4 * dy - int(pred_mv[1])))

        tried = {}

        def probe(dx, dy):
            if abs(dx) > sr or abs(dy) > sr:
                return None
            key = (dx, dy)
            if key in tried:
                return tried[key]
            c = mcost(dx, dy)
            tried[key] = c
            return c

        # start-point prediction: median pred, (0,0), up-layer seed,
        # co-located MV of the reference (pred_MV_ref)
        cands = [(int(pred_mv[0]) >> 2, int(pred_mv[1]) >> 2), (0, 0)]
        if seed is not None:
            cands.append((int(seed[0]), int(seed[1])))
        tm = self.temporal[r]
        if tm is not None:
            tmv = tm[addr, 0]
            cands.append((int(tmv[0]) >> 2, int(tmv[1]) >> 2))
        best, best_c = None, None
        for (dx, dy) in cands:
            c = probe(dx, dy)
            if c is not None and (best_c is None or c < best_c):
                best, best_c = (dx, dy), c

        def local_diamond():
            nonlocal best, best_c
            cx, cy = best
            for ox, oy in _DIAMOND:
                c = probe(cx + ox, cy + oy)
                if c is not None and c < best_c:
                    best, best_c = (cx + ox, cy + oy), c

        local_diamond()
        if best_c < et:                       # EARLY_TERMINATION
            return self._fin(addr, r, bt, best, best_c)

        # unsymmetrical cross: horizontal +-SR step 2, vertical +-SR/2
        cx, cy = best
        for i in range(1, sr, 2):
            for dx in (cx + i, cx - i):
                c = probe(dx, cy)
                if c is not None and c < best_c:
                    best, best_c = (dx, cy), c
        for i in range(1, sr // 2, 2):
            for dy in (cy + i, cy - i):
                c = probe(cx, dy)
                if c is not None and c < best_c:
                    best, best_c = (cx, dy), c
        if best_c < et:
            return self._fin(addr, r, bt, best, best_c)

        # uneven multi-hexagon-grid: 5x5 window + big hexagon rings
        cx, cy = best
        for ox, oy in _WIN5:
            c = probe(cx + ox, cy + oy)
            if c is not None and c < best_c:
                best, best_c = (cx + ox, cy + oy), c
        if best_c >= et:
            for scale in range(1, max(1, sr // 4) + 1):
                for hx, hy in _BIG_HEX:
                    c = probe(cx + hx * scale, cy + hy * scale)
                    if c is not None and c < best_c:
                        best, best_c = (cx + hx * scale, cy + hy * scale), c
                if best_c < et:
                    break

        # extended hexagon-based search: hexagon until converged, then
        # small diamond until converged
        for pattern in (_HEXAGON, _DIAMOND):
            for _ in range(sr):
                cx, cy = best
                improved = False
                for ox, oy in pattern:
                    c = probe(cx + ox, cy + oy)
                    if c is not None and c < best_c:
                        best, best_c = (cx + ox, cy + oy), c
                        improved = True
                if not improved:
                    break
        return self._fin(addr, r, bt, best, best_c)

    def _fin(self, addr, r, bt, best, best_c):
        if bt in self.prev_sad:
            self.prev_sad[bt][r, addr] = best_c
        return np.array(best, np.int32)


class UMHexSmpSearcher(UMHexSearcher):
    """SearchMode 2: simplified UMHexagonS (me_umhexsmp.c) — predictor
    check, small cross-diamond, then convergence hexagon/diamond."""

    def search(self, addr: int, r: int, quads, pred_mv,
               seed=None) -> np.ndarray:
        sr, lam = self.sr, self.lam
        quads = tuple(quads)
        bt = _blocktype(quads)
        et = _ET_THRED.get(bt, 800) * len(quads) // 2

        def mcost(dx, dy):
            return (self._sad(addr, r, quads, dx, dy)
                    + lam * mv_bits(4 * dx - int(pred_mv[0]),
                                    4 * dy - int(pred_mv[1])))

        tried = {}

        def probe(dx, dy):
            if abs(dx) > sr or abs(dy) > sr:
                return None
            if (dx, dy) in tried:
                return tried[(dx, dy)]
            c = mcost(dx, dy)
            tried[(dx, dy)] = c
            return c

        cands = [(int(pred_mv[0]) >> 2, int(pred_mv[1]) >> 2), (0, 0)]
        if seed is not None:
            cands.append((int(seed[0]), int(seed[1])))
        best, best_c = None, None
        for (dx, dy) in cands:
            c = probe(dx, dy)
            if c is not None and (best_c is None or c < best_c):
                best, best_c = (dx, dy), c

        # small cross-diamond (smpUMHEX first phase)
        cx, cy = best
        for ox, oy in _DIAMOND + ((-2, 0), (2, 0), (0, -2), (0, 2)):
            c = probe(cx + ox, cy + oy)
            if c is not None and c < best_c:
                best, best_c = (cx + ox, cy + oy), c
        if best_c < et:
            return self._fin(addr, r, bt, best, best_c)

        for pattern in (_HEXAGON, _DIAMOND):
            for _ in range(sr):
                cx, cy = best
                improved = False
                for ox, oy in pattern:
                    c = probe(cx + ox, cy + oy)
                    if c is not None and c < best_c:
                        best, best_c = (cx + ox, cy + oy), c
                        improved = True
                if not improved:
                    break
        return self._fin(addr, r, bt, best, best_c)
