"""The serial host P macroblock coder of the port: twin of
jm_tpu/encoder/encoder.py _FrameEncoder._encode_p_mb (:2706-2878) with
its RD tiers _p_mode_rd and _highfast_intra_skip (:2905-3017),
_commit_inter_p (:3019-3113) and its _code_luma_inter, for 4:2:0 frame
pictures and field pictures (the field scan, the chroma offset of a
reference field of the other parity): one or several list-0
references, P8x8 sub-partitions (sub8x8), the full search or the EPZS /
UMHex searchers (encoder/me_epzs.py, me_umhex.py), the fractional
search by SATD or SAD (subpel_satd), a QP per basic unit (basic-unit
rate control), flat quant or the custom quant of
encoder/qmatrix.QuantCtx, the 4x4 or the adaptive 8x8 transform. jm_tpu
codes every P picture this way whose pipeline is "host", or whose coding
its device path does not cover (several active references, sub-8x8
partitions, basic-unit rate control, weighted prediction, custom quant,
the 8x8 transform, an RD tier, I_PCM, simulated lossy decoders), and so
does the port.

Per MB, in slice order (with basic units, at the QP of the MB's unit):
  - with enable_ipcm 2, I_PCM;
  - an MB of the intra refresh set is coded Intra16x16 with its chroma;
  - else, for each partition mode (16x16, 16x8, 8x16, 8x8) and each of
    its partitions, for each reference r: the MV predictor (seeing the
    mode's earlier partitions, committed provisionally), the integer MV
    of least SAD + lambda-weighted mvd bits, over the quadrant SAD table
    of r made on the device (ops/enc.full_search_sad_quad) with the
    spiral tie-break, or by the picture's searcher (seeded with
    reference 0's MV), then the half- / quarter-pel refinement on the
    unweighted reference with the ref_idx bits added (the arg-min and
    the refinement by the native runtime: InterMBCoder.native_me); the
    reference of least cost (the first on a tie); the mode of least
    total cost (lambda times its mb_type bits added);
  - with sub8x8, each quadrant of the 8x8 mode tries the sub-partitions
    8x8, 8x4, 4x8 and 4x4 on the quadrant's reference, each sub-block by
    its own integer search over the 4x4 table (ops/enc
    .full_search_sad_blk4) and refinement, or under a searcher refined
    from the quadrant's quarter-pel MV; the quadrants in order, each
    seeing the sub-motion chosen before it; the 8x8 mode takes the
    sub-partitions when their total is below its own;
  - with rdo, the RD decision of _p_mode_rd over full codings of the
    partition modes, the forced P_Skip, Intra16x16, Intra4x4 and, with
    enable_ipcm, I_PCM; else P_Skip's prediction (reference 0),
    weighted, replaces the mode when its SAD is not above it, and
    Intra16x16 replaces both when its SAD + 2 lambda_mode4 is below;
then the prediction of each 4x4 block from its quadrant's reference
(quarter-pel luma, eighth-pel chroma), weighted by the slice's explicit
table of that reference (decoder/wp.WPParams), the inter residual and
the recon (encoder/b_host.InterMBCoder). As in jm_tpu, the motion search
ignores the weights: only the skip cost and the coded prediction are
weighted.
"""

from __future__ import annotations

import time

import numpy as np

from ..common.picture import MB_I4, MB_I16, MB_INTER, MB_IPCM
from ..common.types import SliceType
from . import me as ME
from . import residual_np as RN
from .b_host import InterMBCoder
from .rdo import MBState, lambda_mode, mb_ssd

# partition mode -> [(bx, by, bw, bh, quadrants)] in 4x4-block units
PART_TABLE = {
    0: [(0, 0, 4, 4, (0, 1, 2, 3))],
    1: [(0, 0, 4, 2, (0, 1)), (0, 2, 4, 2, (2, 3))],
    2: [(0, 0, 2, 4, (0, 2)), (2, 0, 2, 4, (1, 3))],
    3: [(0, 0, 2, 2, (0,)), (2, 0, 2, 2, (1,)),
        (0, 2, 2, 2, (2,)), (2, 2, 2, 2, (3,))],
}
# the rate term of each mode in the decision, in lambdas
MODE_BITS = {0: 1, 1: 3, 2: 3, 3: 5 + 4}
_MIX = ("skip", "p16x16", "p16x8", "p8x16", "p8x8", "i16", "i4", "ipcm",
        "t8")
_INTRA_MIX = {MB_I16: "i16", MB_I4: "i4", MB_IPCM: "ipcm"}


class PPicture(InterMBCoder):
    """One P picture coded MB by MB on the host: ``pic`` (PictureData)
    and the undeblocked recon planes recY / recU / recV (numpy uint8).
    ``mix`` counts the MBs by decision (skip, p16x16, p16x8, p8x16,
    p8x8, i16: Intra16x16, forced or chosen, i4: Intra4x4, ipcm: I_PCM;
    t8: the inter MBs coded with the 8x8 transform); ``ref1`` the
    partitions (and sub-8x8 quadrants) coded from a reference other than
    reference 0; ``part_s`` the wall seconds of the MB loop's parts: the
    partition-mode search, the skip candidate, the intra evaluation and
    coding, the inter commit, and with rdo the trial codings of the RD
    decision (rd), in an SP picture the SP levels and recon inside the
    commit (sp); ``evals`` the searcher's SAD evaluations (0 under full
    search)."""

    stype = SliceType.P
    # the SP level decision by the native runtime (jm_enc.cpp sp_levels);
    # False: residual_np's Python loop, its twin
    native_sp = True

    def __init__(self, orig, qp: int, qpc: int, lam: int, lam4: int,
                 refs, sads, slices, sr: int, forced=(), wp=None,
                 transform8x8=False, qctx=None, ar_period: int = 0,
                 blk4=None, searcher=None, sub8x8: bool = False,
                 subpel_satd: bool = True, units=None, rd=None,
                 num_ref: int | None = None, parity=None, sp=None):
        """orig: the source (Y, U, V) uint8 planes; lam / lam4:
        lambda_me and lambda_mode4 of qp; refs: list0's active references
        (HostRef), by ref_idx; sads: their (N, (2 sr + 1)^2, 4) quadrant
        integer search tables (None with a searcher); slices: the slice
        plan, MB address lists in decode order; forced: the MBs of the
        intra refresh; wp: the slice's weighted prediction
        (decoder/wp.WPParams) or None; transform8x8, qctx, ar_period: the
        adaptive 8x8 transform and the custom quant (InterMBCoder,
        IntraMBCoder); blk4: the references' (N, (2 sr + 1)^2, 16) 4x4
        tables, for sub8x8 under full search; searcher: searcher(pic_mv)
        makes the picture's EPZS / UMHex searcher over its motion field
        (encoder/me_epzs.py), or None for the full search; sub8x8: the
        P8x8 sub-partitions; subpel_satd: SATD (else SAD) in the
        fractional search; units: the basic units of rate control
        (IntraMBCoder._code_slices), or None; rd: the RD tools
        (rdo.RDOptions: the RD tiers of _p_mode_rd, the trellis, I_PCM,
        the simulated lossy decoders of tier 3); num_ref: the active
        list-0 references that the RD bit counts write (len(refs) unless
        given: the redundant coding, one reference, counts the
        primary's, as jm_tpu does); parity: a field picture's (0 top, 1
        bottom: the field scan, and the chroma offset of the reference
        fields of the other parity), None for a frame picture; sp: an SP
        picture's (QS, its chroma QP with the PPS offset), or None."""
        if rd is not None:
            self.rd = rd
        self._init_picture(orig, qp, qpc)
        self.set_parity(parity)
        self.sp = sp
        if sp is not None:
            # every MB of an SP slice takes its bS, QS and, when inter,
            # the requantizing recon (jm_tpu encoder.py:2120-2124)
            self.stype = SliceType.SP
            self.pic.sp_slice[:] = True
            self.pic.sp_qs[:] = sp[0]
        self.lam, self.lam4, self.wp = lam, lam4, wp
        self.transform8x8 = transform8x8
        self.qctx, self.ar_period = qctx, ar_period
        self.refs, self.sads, self.blk4, self.sr = refs, sads, blk4, sr
        self.num_ref = len(refs) if num_ref is None else num_ref
        self.sub8x8, self.satd = sub8x8, subpel_satd
        self.units = units
        self.searcher = searcher(self.pic.mv) if searcher else None
        self.forced = set(forced)
        self.h, self.w = self.origY.shape
        self.recY = np.zeros_like(self.origY)
        self.recU = np.zeros_like(self.origU)
        self.recV = np.zeros_like(self.origV)
        self.mix = dict.fromkeys(_MIX, 0)
        self.ref1 = 0
        self.part_s = dict.fromkeys(("search", "skip", "intra", "commit",
                                     "rd"), 0.0)
        if sp is not None:
            self.part_s["sp"] = 0.0      # the SP levels and recon (commit)
        self._code_slices(slices, self._encode_p_mb)
        self.evals = 0 if self.searcher is None else self.searcher.n_evals

    def _intra16(self, addr, origY_mb, mode16, pred16) -> None:
        pic = self.pic
        pic.ref_idx[addr] = -1
        cbp_luma = self._encode_i16(addr, origY_mb, mode16, pred16)
        pic.cbp[addr] = (self._encode_chroma_intra(addr) << 4) | cbp_luma

    def _tally(self, addr) -> None:
        """Count the decided MB in mix and its partitions from a later
        reference in ref1."""
        pic = self.pic
        cls = int(pic.mb_class[addr])
        if cls != MB_INTER:
            self.mix[_INTRA_MIX[cls]] += 1
            return
        mode = int(pic.inter_mode[addr])
        self.mix["skip" if pic.skip[addr] else _MIX[1 + mode]] += 1
        self.mix["t8"] += int(pic.transform8x8[addr])
        self.ref1 += sum(int(pic.ref_idx[addr, quads[0]]) > 0
                         for (_x, _y, _w, _h, quads) in PART_TABLE[mode])

    def _int_search(self, addr, r, quads, pred, seed):
        """The integer MV of a partition (its quadrants) from reference r:
        the searcher's, or the full search's over r's quadrant table."""
        if self.searcher is not None:
            return self.searcher.search(addr, r, quads, pred, seed=seed)
        return self._int_mv(self.sads[r][addr], quads, pred)

    def _encode_p_mb(self, addr: int) -> None:
        self._code_p_mb(addr)
        self._tally(addr)

    def _code_p_mb(self, addr: int) -> None:
        pic, lam = self.pic, self.lam
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        origY_mb = self._mb_orig(addr)[0]
        t0 = time.perf_counter()
        if self.rd.enable_ipcm >= 2:       # forced I_PCM (jm_tpu :2713)
            self._commit_ipcm(addr)
            self.part_s["intra"] += time.perf_counter() - t0
            return
        if addr in self.forced:            # intra refresh
            self._intra16(addr, origY_mb, *self._eval_i16(addr,
                                                          origY_mb)[1:])
            self.part_s["intra"] += time.perf_counter() - t0
            return
        o = origY_mb.astype(np.int32)
        nref = len(self.refs)
        # te(v) of ref_idx: one bit with two references, else ue(v)
        ref_bits = [(1 if nref == 2 else ME.ue_len(r)) if nref > 1 else 0
                    for r in range(nref)]

        # the partition modes; each partition's predictor sees the mode's
        # earlier partitions (provisional commits), as the reference's
        # PartitionMotionSearch
        candidates = {}
        for mode, parts in PART_TABLE.items():
            total = lam * MODE_BITS[mode]
            commit = []
            pic.mv[addr] = 0
            pic.ref_idx[addr] = -1
            for (bx, by, bw, bh, quads) in parts:
                blk = self.origY[py + by * 4:py + by * 4 + bh * 4,
                                 px + bx * 4:px + bx * 4 + bw * 4]
                best, seed = None, None
                for r in range(nref):
                    pred = self.pctx.mv_pred(addr, bx, by, bw, bh, r)
                    imv0 = self._int_search(addr, r, quads, pred, seed)
                    if r == 0 and self.searcher is not None:
                        seed = imv0
                    qmv, cost = self._subpel(
                        blk, self.refs[r], px + bx * 4, py + by * 4, imv0,
                        pred, extra_bits=ref_bits[r])
                    if best is None or cost < best[0]:
                        best = (cost, r, qmv)
                total += best[0]
                commit.append((bx, by, bw, bh, quads, best[1], best[2]))
                for yy in range(by, by + bh):
                    for xx in range(bx, bx + bw):
                        pic.mv[addr, yy * 4 + xx] = best[2]
                for q in quads:
                    pic.ref_idx[addr, q] = best[1]
            candidates[mode] = (total, commit)
        pic.mv[addr] = 0
        pic.ref_idx[addr] = -1
        sub_commit = self._sub8x8(addr, candidates) if self.sub8x8 else None
        t1 = time.perf_counter()
        self.part_s["search"] += t1 - t0
        skip_mv = self.pctx.skip_mv(addr)
        if self.rd.rdo:
            self._p_mode_rd(addr, candidates, sub_commit, skip_mv, o)
            self.part_s["rd"] += time.perf_counter() - t1
            return
        best_mode = min(candidates, key=lambda m: candidates[m][0])
        cost_inter, commit = candidates[best_mode]

        # the skip candidate: 16x16, reference 0, the predicted MV, no bits
        skip_pred = ME.mc_luma_block(
            self.refs[0].planes, px * 4 + int(skip_mv[0]),
            py * 4 + int(skip_mv[1]), 16, 16, self.w, self.h)
        if self.wp is not None:
            skip_pred = self.wp.uni(skip_pred, 0, 0, 0)
        cost_skip = int(np.abs(o - skip_pred).sum())
        if cost_skip <= cost_inter:
            best_mode, cost_inter = 0, cost_skip
            commit = [(0, 0, 4, 4, (0, 1, 2, 3), 0, skip_mv.copy())]
        t2 = time.perf_counter()
        self.part_s["skip"] += t2 - t1

        # the intra-16 fallback (scene changes, uncovered areas)
        cost16, mode16, pred16 = self._eval_i16(addr, origY_mb)
        if cost16 + 2 * self.lam4 < cost_inter:
            self._intra16(addr, origY_mb, mode16, pred16)
            self.part_s["intra"] += time.perf_counter() - t2
            return
        t3 = time.perf_counter()
        self.part_s["intra"] += t3 - t2
        self._commit_inter(addr, best_mode, commit, sub_commit, skip_mv, o)
        self.part_s["commit"] += time.perf_counter() - t3

    def _sub8x8(self, addr, candidates):
        """The P8x8 sub-partition refinement (jm_tpu :2783-2848): each
        quadrant of the 8x8 mode on its reference, the sub-modes in
        SUB_PARTS order, each sub-block by its own integer search over the
        4x4 table or, under a searcher, refined from the quadrant's
        quarter-pel MV. Replaces the 8x8 mode's cost and returns the
        sub-commits when their total is below it, else None."""
        pic, lam = self.pic, self.lam
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        total3 = lam * MODE_BITS[3]
        sub_commit = []
        pic.mv[addr] = 0
        pic.ref_idx[addr] = -1
        for (bx, by, _bw, _bh, quads, r, qmv8) in candidates[3][1]:
            ref = self.refs[r]
            pic.ref_idx[addr, quads[0]] = r
            best_q = None
            for sm, parts in ME.SUB_PARTS.items():
                mvs, cost_q = [], lam * ME.SUB_MODE_BITS[sm]
                for (sx, sy, sw, sh) in parts:
                    x0, y0 = px + (bx + sx) * 4, py + (by + sy) * 4
                    pred = self.pctx.mv_pred(addr, bx + sx, by + sy, sw, sh,
                                             r)
                    blk = self.origY[y0:y0 + sh * 4, x0:x0 + sw * 4]
                    if self.searcher is None:
                        ids = [(by + sy + yy) * 4 + bx + sx + xx
                               for yy in range(sh) for xx in range(sw)]
                        simv = self._int_mv(self.blk4[r][addr], ids, pred)
                        qmv, c = self._subpel(blk, ref, x0, y0, simv, pred)
                    else:
                        qmv, c = self._subpel(blk, ref, x0, y0, qmv8, pred,
                                              qpel_start=True)
                    mvs.append(qmv)
                    cost_q += c
                    for yy in range(by + sy, by + sy + sh):
                        for xx in range(bx + sx, bx + sx + sw):
                            pic.mv[addr, yy * 4 + xx] = qmv
                if best_q is None or cost_q < best_q[0]:
                    best_q = (cost_q, sm, mvs)
            # the winner's motion stays for the next quadrants' predictors
            for (sx, sy, sw, sh), qmv in zip(ME.SUB_PARTS[best_q[1]],
                                             best_q[2]):
                for yy in range(by + sy, by + sy + sh):
                    for xx in range(bx + sx, bx + sx + sw):
                        pic.mv[addr, yy * 4 + xx] = qmv
            total3 += best_q[0]
            sub_commit.append((bx, by, quads[0], r, best_q[1], best_q[2]))
        pic.mv[addr] = 0
        pic.ref_idx[addr] = -1
        if total3 < candidates[3][0]:
            candidates[3] = (total3, candidates[3][1])
            return sub_commit
        return None

    def _commit_inter(self, addr, mode, commit, sub_commit, skip_mv, o,
                      no_residual: bool = False) -> None:
        """Commit the chosen motion (the sub-partitions' with P_8x8 and
        sub_commit), predict each 4x4 block from its quadrant's reference
        (weighted), code the residual (with no_residual none: the forced
        P_Skip trial of the RD decision, whose recon is the prediction);
        P_Skip when the 16x16 coding is the skip coding."""
        pic = self.pic
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        pic.mb_class[addr] = MB_INTER
        pic.inter_mode[addr] = mode
        if mode == 3 and sub_commit is not None:
            for (bx, by, q, r, sm, mvs) in sub_commit:
                pic.sub_mode[addr, q] = sm
                pic.ref_idx[addr, q] = r
                pic.ref_pic_id[addr, q] = self.refs[r].uid
                pic.pdir[addr, q] = 0
                for (sx, sy, sw, sh), qmv in zip(ME.SUB_PARTS[sm], mvs):
                    for yy in range(by + sy, by + sy + sh):
                        for xx in range(bx + sx, bx + sx + sw):
                            pic.mv[addr, yy * 4 + xx] = qmv
        else:
            for (bx, by, bw, bh, quads, r, qmv) in commit:
                for yy in range(by, by + bh):
                    for xx in range(bx, bx + bw):
                        pic.mv[addr, yy * 4 + xx] = qmv
                for q in quads:
                    pic.ref_idx[addr, q] = r
                    pic.ref_pic_id[addr, q] = self.refs[r].uid
                    pic.pdir[addr, q] = 0
        cbh = self.crows                 # chroma rows per luma 4x4 row
        pred_y = np.zeros((16, 16), np.int64)
        pred_u = np.zeros((self.ch, 8), np.int64)
        pred_v = np.zeros((self.ch, 8), np.int64)
        for blk in range(16):
            by, bx = divmod(blk, 4)
            r = int(pic.ref_idx[addr, (by // 2) * 2 + bx // 2])
            p = self._mc_blk(self.refs[r], px, py, bx, by, pic.mv[addr, blk])
            if self.wp is not None:
                p = [self.wp.uni(b, 0, r, c) for c, b in enumerate(p)]
            pred_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = p[0]
            pred_u[by * cbh:(by + 1) * cbh, bx * 2:bx * 2 + 2] = p[1]
            pred_v[by * cbh:(by + 1) * cbh, bx * 2:bx * 2 + 2] = p[2]
        if self.sp is not None:
            pic.sp_mb[addr] = pic.sp_slice[addr] = True
            pic.sp_qs[addr] = self.sp[0]
        if no_residual:
            if self.sp is not None:
                # the QS-requantized prediction (jm_tpu _sp_recon)
                recs = self._sp_recon(pred_y, pred_u, pred_v)
            else:
                recs = (np.clip(p, 0, 255) for p in (pred_y, pred_u, pred_v))
            y, u, v = recs
            self.recY[py:py + 16, px:px + 16] = y
            self.recU[self._csl(addr)] = u
            self.recV[self._csl(addr)] = v
            pic.cbp[addr] = 0
        elif self.sp is not None:
            t0 = time.perf_counter()
            cbp_luma = self._code_luma_inter_sp(addr, o, pred_y)
            cbp_chroma = self._code_chroma_sp(addr, pred_u, pred_v)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma
            self.part_s["sp"] += time.perf_counter() - t0
        else:
            self._commit_inter_residual(addr, o, pred_y, pred_u, pred_v)
        if (mode == 0 and pic.cbp[addr] == 0 and pic.ref_idx[addr, 0] == 0
                and (pic.mv[addr, 0] == skip_mv).all()):
            pic.skip[addr] = True

    # ---- SP pictures (jm_tpu encoder.py:3227-3325) -------------------------

    def _sp_lam(self) -> float:
        # lencod block.c:1551: lambda_mode = 0.85 * 2^((qp - 12) / 3) * 4
        return 0.85 * 2.0 ** ((self.qp - 12) / 3.0) * 4.0

    def _code_luma_inter_sp(self, addr, o, pred_y) -> int:
        """The SP luma levels (residual_np.sp_luma_levels_mb, lencod
        residual_transform_quant_luma_4x4_sp), JM's quadrant / MB
        thresholds applied to them, then the requantizing recon; commits
        the levels, nnz and recon and returns cbp_luma."""
        pic = self.pic
        px, py = (addr % self.mb_w) * 16, (addr // self.mb_w) * 16
        lam = self._sp_lam()
        qs = self.sp[0]
        ob = o.astype(np.int64).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 4, 4)
        pb = pred_y.astype(np.int64).reshape(4, 4, 4, 4) \
            .transpose(0, 2, 1, 3).reshape(16, 4, 4)
        scan4, Ps = RN.sp_luma_levels_mb(ob, pb, self.qp, qs, lam,
                                         native=self.native_sp)
        total_cost = 0
        for qb in ME.QUAD_BLKS:
            cq = sum(RN.coeff_cost_scan(scan4[b]) for b in qb)
            if cq <= RN.LUMA_COEFF_COST:
                scan4[qb] = 0
            else:
                total_cost += cq
        if total_cost <= RN.LUMA_MB_COEFF_COST:
            scan4[:] = 0
        rec4 = RN.sp_luma_recon(Ps, scan4, self.qp, qs)
        self.recY[py:py + 16, px:px + 16] = \
            rec4.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        pic.luma_coef[addr] = scan4
        nnz = (scan4 != 0).sum(axis=1)
        pic.luma_nnz[addr] = nnz
        return sum(1 << q for q, qb in enumerate(ME.QUAD_BLKS)
                   if nnz[qb].any())

    def _code_chroma_sp(self, addr, pred_u, pred_v) -> int:
        """The SP chroma of a 4:2:0 MB (lencod
        residual_transform_quant_chroma_4x4_sp): the DC through the
        prediction's 2x2 Hadamard, the AC as luma; the requantizing
        recon; returns cbp_chroma."""
        pic = self.pic
        cx, cy = (addr % self.mb_w) * 8, (addr // self.mb_w) * 8
        lam = self._sp_lam()
        qsc = self.sp[1]
        any_dc = any_ac = False
        for comp, (orig, pred8, plane) in enumerate(
                ((self.origU, pred_u, self.recU),
                 (self.origV, pred_v, self.recV))):
            o8 = orig[cy:cy + 8, cx:cx + 8].astype(np.int64)
            dc, ac, P, mp1 = RN.sp_chroma_levels(o8, pred8, self.qpc, qsc,
                                                 lam, native=self.native_sp)
            pic.chroma_dc[addr, comp] = dc
            pic.chroma_coef[addr, comp] = ac
            pic.chroma_nnz[addr, comp] = (ac[:, 1:] != 0).sum(axis=1)
            any_dc = any_dc or bool((dc != 0).any())
            any_ac = any_ac or bool((ac != 0).any())
            plane[cy:cy + 8, cx:cx + 8] = RN.sp_chroma_recon(
                P, mp1, dc, ac, self.qpc, qsc)
        return 2 if any_ac else (1 if any_dc else 0)

    def _sp_recon(self, pred_y, pred_u, pred_v):
        """The SP recon of an MB without levels (the forced P_Skip trial):
        the QS-requantized prediction."""
        qs, qsc = self.sp
        pb = pred_y.astype(np.int64).reshape(4, 4, 4, 4) \
            .transpose(0, 2, 1, 3).reshape(16, 4, 4)
        rec4 = RN.sp_luma_recon(RN.np_forward4x4(pb),
                                np.zeros((16, 16), np.int64), self.qp, qs)
        out = [rec4.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
               .reshape(16, 16)]
        for pred8 in (pred_u, pred_v):
            pbc = pred8.astype(np.int64).reshape(2, 4, 2, 4) \
                .transpose(0, 2, 1, 3)
            P = RN.np_forward4x4(pbc.reshape(4, 4, 4)).reshape(2, 2, 4, 4)
            out.append(RN.sp_chroma_recon(
                P, np.array(RN._h2(P)), np.zeros(4, np.int64),
                np.zeros((4, 16), np.int64), self.qpc, qsc))
        return out

    # ---- the RD tiers (jm_tpu encoder.py:2905-3017) ------------------------

    def _p_mode_rd(self, addr, candidates, sub_commit, skip_mv, o) -> None:
        """The md_high family (lencod rdopt.c:242): each candidate coded
        in full from the same state and the least J = SSD +
        lambda_mode times its bits kept (the first on a tie), plus with
        the simulated lossy decoders (tier 3) the error energy an inter
        MB inherits. Candidates: the partition modes, by their search
        cost (tier 4: 8x8, 8x16, 16x8, 16x16, md_high_updated's order),
        tier 2 stopping when the 16x16 coding is P_Skip (EarlySkip); the
        forced P_Skip without residual, after which tier 2 drops the intra
        trials when the best rate is at most the boundary error
        (_highfast_intra_skip); Intra16x16; Intra4x4; with enable_ipcm,
        I_PCM."""
        pic, rd = self.pic, self.rd
        tier = rd.rdo
        lam = lambda_mode(self.qp)
        base = MBState(self, addr)
        best, best_bits = None, 0
        errdo = rd.errdo

        def consider():
            nonlocal best, best_bits
            bits = self._mb_bits(addr)
            j = mb_ssd(self, addr) + lam * bits
            if errdo is not None:
                j += errdo.mb_error_energy(pic, addr, self.mb_w)
            if best is None or j < best[0]:
                best, best_bits = (j, MBState(self, addr)), bits

        if tier == 4:
            order = [m for m in (3, 2, 1, 0) if m in candidates]
        else:
            order = sorted(candidates, key=lambda k: candidates[k][0])
        for m in order:
            base.restore()
            self._commit_inter(addr, m, candidates[m][1],
                               sub_commit if m == 3 else None, skip_mv, o)
            consider()
            if tier == 2 and m == 0 and pic.skip[addr]:
                best[1].restore()
                return
        base.restore()
        self._commit_inter(addr, 0, [(0, 0, 4, 4, (0, 1, 2, 3), 0,
                                      skip_mv.copy())], None, skip_mv, o,
                           no_residual=True)
        consider()
        if tier == 2 and self._highfast_intra_skip(addr, best_bits):
            best[1].restore()
            return
        origY_mb = self._mb_orig(addr)[0]
        base.restore()
        self._intra16(addr, origY_mb, *self._eval_i16(addr, origY_mb)[1:])
        consider()
        base.restore()
        pic.ref_idx[addr] = -1
        _c4, cbp_luma4 = self._encode_i4_mb(addr, origY_mb)
        pic.cbp[addr] = (self._encode_chroma_intra(addr) << 4) | cbp_luma4
        consider()
        if rd.enable_ipcm:
            base.restore()
            self._commit_ipcm(addr)
            consider()
        best[1].restore()

    def _highfast_intra_skip(self, addr, best_bits: int) -> bool:
        """md_highfast's SelectiveIntraEnable (md_highfast.c:40): drop the
        intra trials when the best inter coding's average rate bits / 384
        is at most the average boundary error (the SAD of the source's top
        row and left column against the recon beside them, luma and both
        chroma, / 64); never at the picture's border."""
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        if (mbx == 0 or mby == 0 or mbx == self.mb_w - 1
                or mby == self.mb_h - 1):
            return False
        px, py = mbx * 16, mby * 16
        o = self._mb_orig(addr)[0].astype(np.int32)
        sbe = int(np.abs(o[0] - self.recY[py - 1, px:px + 16]
                         .astype(np.int32)).sum())
        sbe += int(np.abs(o[:, 0] - self.recY[py:py + 16, px - 1]
                          .astype(np.int32)).sum())
        mh = self.ch
        cx, cy = mbx * 8, mby * mh
        for plane, orig in ((self.recU, self.origU), (self.recV, self.origV)):
            oc = orig[cy:cy + mh, cx:cx + 8].astype(np.int32)
            sbe += int(np.abs(oc[0] - plane[cy - 1, cx:cx + 8]
                              .astype(np.int32)).sum())
            sbe += int(np.abs(oc[:, 0] - plane[cy:cy + mh, cx - 1]
                              .astype(np.int32)).sum())
        return best_bits / 384.0 <= sbe / 64.0
