"""Rate control of the port: the JVT-G012 quadratic model at frame level
(RC_MODE_0) and the basic units within a P picture, a copy of
jm_tpu/ratectl.py's qp2qstep / qstep2qp, _two_pass_lsq, _lin_two_pass,
RateControl and BasicUnitRC, statement for statement: QP decisions are
step functions of least-squares fits in Python floats (float64), so any
reordering of the arithmetic can flip one QP and every byte after it.

Behavioral parity with lencod/src/rc_quadratic.c / ratectl.c:
  - initial QP from bpp thresholds              (rc_init_seq:268-292)
  - GOP bit allocation + bounds                 (rc_init_GOP:312)
  - per-picture target: remaining-bit share blended with buffer-level
    feedback, GAMMAP/BETAP                      (rc_init_pict:626-676)
  - P QP from the quadratic R-D model R = X1*MAD/Q + X2*MAD/Q^2 solved
    for Qstep, clipped to +-RCMaxQPChange       (updateQPRC0:1292,
    updateModelQPFrame:2469)
  - B QP interpolated between surrounding anchors (updateQPRC0:1315-1356)
  - model update: (Qstep, texture-bits/MAD) history window sized by MAD
    ratio, two-pass least squares with outlier rejection
    (updateRCModel:920, RCModelEstimator:1055)
  - MAD prediction: linear model MAD = C1*MAD_prev + C2 fitted the same
    way (updateMADModel:1128, MADModelEstimator:1218)
  - QP<->Qstep maps                             (ratectl.c QP2Qstep/Qstep2QP)
  - basic units: the QP of the next unit moves with the bits spent
    against the picture's target      (updateQPRC0/1 basic-unit branch)

The controller runs on the host: its decisions are scalar control flow.
"""

from __future__ import annotations

import math

RC_MODEL_HISTORY = 21
_QP2QSTEP = (0.625, 0.6875, 0.8125, 0.875, 1.0, 1.125)


def qp2qstep(qp: int) -> float:
    return _QP2QSTEP[qp % 6] * (1 << (qp // 6))


def qstep2qp(qstep: float) -> int:
    if qstep < qp2qstep(0):
        return 0
    if qstep > qp2qstep(51):
        return 51
    per = 0
    while qstep > qp2qstep(5):
        qstep /= 2.0
        per += 1
    for rem, thr in enumerate((0.65625, 0.75, 0.84375, 0.9375, 1.0625)):
        if qstep <= thr:
            return per * 6 + rem
    return per * 6 + 5


def _two_pass_lsq(x_qs, r_vals, window):
    """RCModelEstimator x2: fit r = X1/q + X2/q^2 against r_vals = R*q...
    (the reference fits m_rgRp = X1/Qstep + X2/Qstep^2 with normal
    equations over (1, 1/q)); returns (X1, X2)."""
    def estimate(rejected):
        n_real = sum(1 for i in range(window) if not rejected[i])
        if n_real == 0:
            return 0.0, 0.0
        qs = [x_qs[i] for i in range(window) if not rejected[i]]
        x1 = sum(x_qs[i] * r_vals[i] for i in range(window)
                 if not rejected[i]) / n_real
        if len(set(qs)) <= 1:
            return x1, 0.0
        a00 = a01 = a11 = b0 = b1 = 0.0
        for i in range(window):
            if rejected[i]:
                continue
            a00 += 1.0
            a01 += 1.0 / x_qs[i]
            a11 += 1.0 / (x_qs[i] * x_qs[i])
            b0 += x_qs[i] * r_vals[i]
            b1 += r_vals[i]
        det = a00 * a11 - a01 * a01
        if abs(det) > 1e-6:
            return ((b0 * a11 - b1 * a01) / det,
                    (b1 * a00 - b0 * a01) / det)
        return b0 / a00, 0.0

    rejected = [False] * window
    x1, x2 = estimate(rejected)
    errs = [x1 / x_qs[i] + x2 / (x_qs[i] * x_qs[i]) - r_vals[i]
            for i in range(window)]
    std = math.sqrt(sum(e * e for e in errs) / window)
    thr = 0.0 if window == 2 else std
    for i in range(window):
        rejected[i] = abs(errs[i]) > thr
    rejected[0] = False          # always keep the newest sample
    return estimate(rejected)


def _lin_two_pass(ref, cur, window):
    """MADModelEstimator: fit cur = C1*ref + C2, two-pass outlier reject."""
    def estimate(rejected):
        n_real = sum(1 for i in range(window) if not rejected[i])
        if n_real == 0:
            return 1.0, 0.0
        refs = [ref[i] for i in range(window) if not rejected[i]]
        c1 = sum(cur[i] / max(ref[i], 1e-9) for i in range(window)
                 if not rejected[i]) / n_real
        if len(set(refs)) <= 1:
            return c1, 0.0
        a00 = a01 = a11 = b0 = b1 = 0.0
        for i in range(window):
            if rejected[i]:
                continue
            a00 += 1.0
            a01 += ref[i]
            a11 += ref[i] * ref[i]
            b0 += cur[i]
            b1 += ref[i] * cur[i]
        det = a00 * a11 - a01 * a01
        if abs(det) > 1e-6:
            c2_ = (b0 * a11 - b1 * a01) / det
            c1_ = (b1 * a00 - b0 * a01) / det
            return c1_, c2_
        return c1, 0.0

    rejected = [False] * window
    c1, c2 = estimate(rejected)
    errs = [c1 * ref[i] + c2 - cur[i] for i in range(window)]
    std = math.sqrt(sum(e * e for e in errs) / window)
    thr = 0.0 if window == 2 else std
    for i in range(window):
        rejected[i] = abs(errs[i]) > thr
    rejected[0] = False
    return estimate(rejected)


class RateControl:
    """Frame-level JVT-G012 controller driving one QP per picture."""

    def __init__(self, bit_rate: float, frame_rate: float, width: int,
                 height: int, num_b: int = 0, initial_qp: int = 0,
                 min_qp: int = 8, max_qp: int = 42, max_qp_change: int = 4):
        self.bit_rate = float(bit_rate)
        self.frame_rate = float(frame_rate)
        self.size = width * height
        self.num_b = num_b
        self.min_qp, self.max_qp = min_qp, max_qp
        self.max_qp_change = max_qp_change
        # rc_init_seq:253-263
        if num_b > 0:
            self.gammap, self.betap = 0.25, 0.9
        else:
            self.gammap, self.betap = 0.5, 0.5
        # initial QP from bpp (rc_init_seq:268-292)
        if initial_qp <= 0:
            bpp = self.bit_rate / (self.frame_rate * self.size)
            if width <= 176:
                l1, l2, l3 = 0.1, 0.3, 0.6
            elif width <= 352:
                l1, l2, l3 = 0.2, 0.6, 1.2
            else:
                l1, l2, l3 = 0.6, 1.4, 2.4
            initial_qp = 35 if bpp <= l1 else 25 if bpp <= l2 else \
                20 if bpp <= l3 else 10
        self.initial_qp = initial_qp

        self.remaining_bits = 0.0
        self.buffer_fullness = 0.0
        self.target_buffer_level = 0.0
        self.delta_p = 0.0
        self.gop_target_buffer_level = 0.0
        self.np = 0
        self.nb = 0
        self.total_p = 0
        self.n_coded_p = 0
        self.n_p_in_gop = 0
        self.n_gop = 0
        # quadratic model state
        self.x1 = self.bit_rate
        self.x2 = 0.0
        self.qs_hist: list[float] = []      # Qstep history (newest first)
        self.rp_hist: list[float] = []      # texture_bits/MAD history
        self.window = 0
        # MAD model
        self.mad_c1, self.mad_c2 = 1.0, 0.0
        self.mad_hist: list[float] = []
        self.mad_window = 0
        self.prev_mad = 1.0
        self.p_qp = initial_qp
        self.prev_last_qp = initial_qp
        self.curr_last_qp = initial_qp
        self.target = 0
        self.wp = 0.0
        self.wb = 0.0

    # ---- GOP ----------------------------------------------------------

    def init_gop(self, n_p: int, n_b: int) -> None:
        """rc_init_GOP: allocate (Np+Nb+1)/framerate seconds of budget."""
        allocated = self.bit_rate * (n_p + n_b + 1) / self.frame_rate
        self.remaining_bits += allocated
        self.np, self.nb = n_p, n_b
        self.total_p = n_p
        self.n_p_in_gop = 0
        self.gop_target_buffer_level = self.buffer_fullness
        self.n_gop += 1

    # ---- per-picture QP -----------------------------------------------

    def pict_qp(self, ptype: str) -> int:
        if ptype == "I":
            self.target = 0
            return self.initial_qp
        if ptype == "B":
            # updateQPRC0 B interpolation (NumberBFrames==1 rule; the
            # multi-B step rule degrades to the same clip band here)
            qc = min(self.prev_last_qp, self.curr_last_qp) + 2
            qc = max(qc, max(self.prev_last_qp, self.curr_last_qp),
                     self.curr_last_qp + 1)
            return min(max(qc, self.min_qp), self.max_qp)
        # P picture
        if self.n_coded_p == 0:
            self.target = 0
            return self.initial_qp
        # target buffer level walk (rc_init_pict:540-551)
        if self.n_p_in_gop == 1:
            self.target_buffer_level = self.buffer_fullness
            self.delta_p = (self.buffer_fullness -
                            self.gop_target_buffer_level) / \
                max(self.total_p - 1, 1)
            self.target_buffer_level -= self.delta_p
        elif self.n_p_in_gop > 1:
            self.target_buffer_level -= self.delta_p
        # target bits (rc_init_pict:670-676)
        denom = self.np * self.wp + self.nb * self.wb
        t_rem = self.wp * self.remaining_bits / denom if denom > 0 else \
            self.bit_rate / self.frame_rate
        t_buf = max(0.0, self.bit_rate / self.frame_rate - self.gammap *
                    (self.buffer_fullness - self.target_buffer_level))
        self.target = int(self.betap * (t_rem - t_buf) + t_buf + 0.5)
        # quadratic solve (updateQPRC0:1380-1410 + updateModelQPFrame)
        mad = self.mad_c1 * self.prev_mad + self.mad_c2
        bits = max(self.target,
                   int(self.bit_rate / (4.0 * self.frame_rate)))
        dtmp = (mad * self.x1) ** 2 + 4 * self.x2 * mad * bits
        if self.x2 == 0.0 or dtmp < 0 or \
                math.sqrt(dtmp) - self.x1 * mad <= 0.0:
            qstep = self.x1 * mad / bits
        else:
            qstep = 2 * self.x2 * mad / (math.sqrt(dtmp) - self.x1 * mad)
        qc = qstep2qp(qstep)
        qc = min(max(qc, self.p_qp - self.max_qp_change),
                 self.p_qp + self.max_qp_change)
        return min(max(qc, self.min_qp), self.max_qp)

    # ---- post-picture update ------------------------------------------

    def update(self, ptype: str, qp: int, bits: int, mad: float,
               header_bits: int = 0) -> None:
        """rc_update_pict + updateRCModel/updateMADModel (frame level)."""
        self.remaining_bits -= bits
        self.buffer_fullness += bits - self.bit_rate / self.frame_rate
        mad = max(mad, 1e-3)
        if ptype == "P":
            self.wp = bits * qp2qstep(qp)        # complexity weight
            self.n_coded_p += 1
            self.n_p_in_gop += 1
            self.np = max(self.np - 1, 0)
            self.p_qp = qp
            self.prev_last_qp = self.curr_last_qp
            self.curr_last_qp = qp
            # model history (newest first)
            self.qs_hist.insert(0, qp2qstep(qp))
            self.rp_hist.insert(0, max(bits - header_bits, 1) / mad)
            del self.qs_hist[RC_MODEL_HISTORY - 1:]
            del self.rp_hist[RC_MODEL_HISTORY - 1:]
            ratio = (self.prev_mad / mad if mad > self.prev_mad
                     else mad / self.prev_mad)
            w = int(ratio * (RC_MODEL_HISTORY - 1))
            w = min(max(w, 1), self.n_coded_p, self.window + 1,
                    RC_MODEL_HISTORY - 1, len(self.qs_hist))
            self.window = w
            self.x1, self.x2 = _two_pass_lsq(self.qs_hist, self.rp_hist, w)
            # MAD model
            self.mad_hist.insert(0, mad)
            del self.mad_hist[RC_MODEL_HISTORY - 1:]
            if len(self.mad_hist) >= 2:
                mw = min(max(int(ratio * (RC_MODEL_HISTORY - 1)), 1),
                         len(self.mad_hist) - 1, 20, self.mad_window + 1)
                self.mad_window = mw
                ref = self.mad_hist[1:mw + 1]
                cur = self.mad_hist[0:mw]
                self.mad_c1, self.mad_c2 = _lin_two_pass(ref, cur, mw)
            self.prev_mad = mad
        elif ptype == "B":
            self.wb = bits * qp2qstep(qp) / 1.3636   # THETA
            self.nb = max(self.nb - 1, 0)
        else:  # I
            self.p_qp = qp
            self.prev_last_qp = qp
            self.curr_last_qp = qp
            self.prev_mad = mad


class BasicUnitRC:
    """Basic-unit QP adaptation within a P picture (lencod rc_quadratic.c
    updateQPRC0/1 basic-unit branch): the picture's target bits are
    spread over its MBs; after each basic unit of basic_unit MBs the QP
    of the next moves with the bits spent against the share expected so
    far, by at most 2 per unit and 6 around the picture's QP."""

    def __init__(self, frame_qp: int, target_bits: float, n_mbs: int,
                 basic_unit: int):
        self.frame_qp = frame_qp
        self.qp = frame_qp
        self.target = max(float(target_bits), 1.0)
        self.n_mbs = n_mbs
        self.bu = max(1, basic_unit)
        self.spent = 0.0
        self.done = 0

    def mb_qp(self) -> int:
        return self.qp

    def report(self, mb_bits: int) -> None:
        """Account one coded MB; adapt the QP at a basic unit's end."""
        self.spent += mb_bits
        self.done += 1
        if self.done % self.bu or self.done >= self.n_mbs:
            return
        expected = self.target * self.done / self.n_mbs
        ratio = self.spent / max(expected, 1.0)
        step = 0
        if ratio > 1.25:
            step = 2
        elif ratio > 1.08:
            step = 1
        elif ratio < 0.80:
            step = -2
        elif ratio < 0.92:
            step = -1
        self.qp = max(self.frame_qp - 6,
                      min(self.frame_qp + 6, self.qp + step))
        self.qp = max(0, min(51, self.qp))
