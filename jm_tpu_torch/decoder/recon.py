"""Host reconstruction of a decoded picture's intra macroblocks, twin of
jm_tpu/decoder/recon.py for 4:2:0 and 4:2:2 frame pictures of 8 to 14
bits and 8-bit 4:2:0 field pictures (their levels in the field scan) with the 4x4 and the 8x8 transform and scaling matrices
(ldecod/src/macroblock.c decode_one_macroblock:1402, block.c itrans4x4 /
itrans_2 / itrans8x8), and the lossless macroblocks of
qpprime_y_zero_transform_bypass_flag (QP'Y 0: the levels are the
residual, intra prediction of modes vertical and horizontal accumulates
it, ldecod block.c itrans4x4_ls / Inv_Residual_trans_*).

``decode_residuals`` is batched numpy over every MB of the picture;
``Reconstructor`` then walks the intra (I4, I8, I16, I_PCM) MBs in
raster order, each predicted from the already reconstructed neighbours. Inter
MBs are never predicted here: they arrive in the seed planes made on the
device by ops/dec.inter_recon_p. The I4 / I8 / I16 walk runs in the
port's C++ runtime (jm_tpu_torch/native, jm_dec.cpp intra_recon) unless the
picture holds an I_PCM MB (whose samples feed later predictions, so the
Python walk interleaves it), is above 8 bits or holds a lossless MB (the
C++ walk is 8-bit and has no DPCM), or the caller asks for the Python
walk (``native=False``); native.routes["recon"] counts the route.
Planes are uint8 at 8 bits, uint16 when either bit depth is above 8.
"""

from __future__ import annotations

import numpy as np

from .. import native as N
from ..common.picture import MB_I4, MB_I16, MB_INTER, MB_IPCM, PictureData
from ..common.predict_ctx import CODE2RASTER, RASTER2CODE
from ..common.tables import (DEQUANT_SCALE_4x4, DEQUANT_SCALE_8x8,
                             SCAN_YUV422, ZIGZAG_4x4, ZIGZAG_8x8, chroma_qp,
                             scan_4x4)
from ..ops.transform import inv8_1d, split_8x8
from . import intra_pred as I

_ZZ = np.asarray(ZIGZAG_4x4)
_ZZ8 = np.asarray(ZIGZAG_8x8)


def _rshift_rnd_sf(x, a: int):
    return (x + (1 << (a - 1))) >> a


def _inv_scan_4x4(coef_scan: np.ndarray, field: bool = False) -> np.ndarray:
    """(..., 16) scan order -> (..., 4, 4) raster: the zig-zag of a frame
    picture, the field scan of a field picture (spec 8.5.6)."""
    out = np.zeros_like(coef_scan)
    out[..., scan_4x4(field)] = coef_scan
    return out.reshape(*coef_scan.shape[:-1], 4, 4)


def _np_inv4(d):
    """Batched spec inverse 4x4 (no rounding); d: (..., 4, 4) int."""
    d = d.astype(np.int64)
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    return np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)


def _np_hadamard4(d):
    d = d.astype(np.int64)
    a0 = d[..., :, 0] + d[..., :, 2]
    a1 = d[..., :, 0] - d[..., :, 2]
    a2 = d[..., :, 1] - d[..., :, 3]
    a3 = d[..., :, 1] + d[..., :, 3]
    f = np.stack([a0 + a3, a1 + a2, a1 - a2, a0 - a3], axis=-1)
    b0 = f[..., 0, :] + f[..., 2, :]
    b1 = f[..., 0, :] - f[..., 2, :]
    b2 = f[..., 1, :] - f[..., 3, :]
    b3 = f[..., 1, :] + f[..., 3, :]
    return np.stack([b0 + b3, b1 + b2, b1 - b2, b0 - b3], axis=-2)


def _np_ihadamard2x4(dc):
    """4:2:2 chroma DC levels (..., 8) in SCAN_YUV422 order through the
    2-point horizontal and 4-point vertical Hadamard (ldecod
    read_comp_cavlc.c:1406-1467): (..., 2, 4) int64, [column][row]."""
    m3 = np.zeros((*np.shape(dc)[:-1], 2, 4), np.int64)
    for k, (i, j) in enumerate(SCAN_YUV422):
        m3[..., i, j] = np.asarray(dc)[..., k]
    m4 = np.stack([m3[..., 0, :] + m3[..., 1, :],
                   m3[..., 0, :] - m3[..., 1, :]], axis=-2)
    m6_0 = m4[..., 0] + m4[..., 2]
    m6_1 = m4[..., 0] - m4[..., 2]
    m6_2 = m4[..., 1] - m4[..., 3]
    m6_3 = m4[..., 1] + m4[..., 3]
    return np.stack([m6_0 + m6_3, m6_1 + m6_2, m6_1 - m6_2, m6_0 - m6_3],
                    axis=-1)


def _np_inv8(d):
    """Batched spec inverse 8x8 (no rounding); d: (..., 8, 8) int."""
    d = d.astype(np.int64)
    t = np.stack(inv8_1d(tuple(d[..., :, i] for i in range(8))), axis=-1)
    return np.stack(inv8_1d(tuple(t[..., j, :] for j in range(8))), axis=-2)


# QP' rows of the scaling tables: 0 .. 51 + QpBdOffset (36 at 14 bits)
QP_ROWS = 88


def build_inv_scale(pps) -> np.ndarray:
    """(6, 88, 4, 4) int32 InvLevelScale = V[qp % 6] * weightScale of the
    PPS's six 4x4 lists (0 intra Y, 1 intra Cb, 2 intra Cr, 3 inter Y,
    4 inter Cb, 5 inter Cr; zig-zag order in the PPS), one row per QP'
    (QP + QpBdOffset)."""
    tab4 = np.zeros((6, QP_ROWS, 4, 4), np.int32)
    v = DEQUANT_SCALE_4x4[np.arange(QP_ROWS) % 6]            # (88, 4, 4)
    for i in range(6):
        ws = np.zeros(16, np.int64)
        ws[_ZZ] = pps.scaling_list_4x4[i]
        tab4[i] = v * ws.reshape(4, 4)
    return tab4


def build_inv_scale8(pps) -> np.ndarray:
    """(2, 88, 8, 8) int32 LevelScale8 = V8[qp % 6] * weightScale8 of the
    PPS's two 4:2:0 8x8 lists (0 intra Y, 1 inter Y: spec lists 6 and
    7), one row per QP'."""
    tab8 = np.zeros((2, QP_ROWS, 8, 8), np.int32)
    v = DEQUANT_SCALE_8x8[np.arange(QP_ROWS) % 6]            # (88, 8, 8)
    for i in range(2):
        ws = np.zeros(64, np.int64)
        ws[_ZZ8] = pps.scaling_list_8x8[i]
        tab8[i] = v * ws.reshape(8, 8)
    return tab8


def decode_residuals(pic: PictureData, pps, bd=(8, 8), lossless=None):
    """Returns (res_luma (n, 16, 4, 4), res_chroma (n, 2, 2 crows, 4, 4))
    int32 spatial residuals of every MB (inverse scan -> dequant -> inverse
    transform; I16 luma DC and chroma DC Hadamards, 2x2 at 4:2:0, 2x4 at
    4:2:2 scaled at QPc + 3; the 8x8 transform of
    MBs with transform8x8, its output split into their 16 raster 4x4
    blocks); products in int64, the dequantized levels kept as int32 as
    in jm_tpu. bd = (luma, chroma) bit depths: the scaling runs at QP' =
    QP + QpBdOffset (spec 8.5.8). lossless: None or the (n,) bool mask of
    the transform-bypass MBs, whose residual is their inverse-scanned
    levels, the luma DC of I16 and the chroma DC placed raw (ldecod
    block.c itrans4x4_ls, read_comp_cavlc.c:2004; jm_tpu
    decode_residuals(bd=, lossless=))."""
    n = pic.n_mbs
    qp = pic.qp.astype(np.int64) + 6 * (bd[0] - 8)
    tab4 = build_inv_scale(pps)
    intra = pic.mb_class != MB_INTER
    per = qp // 6
    fld = pic.field_mode

    # ---- luma: intra -> list 0, inter -> list 3 ----
    raster = _inv_scan_4x4(pic.luma_coef, fld)                  # (n, 16, 4, 4)
    scale_y = tab4[np.where(intra, 0, 3), qp].astype(np.int64)  # (n, 4, 4)
    deq = _rshift_rnd_sf((raster.astype(np.int64) * scale_y[:, None])
                         << per[:, None, None, None], 4).astype(np.int32)
    i16 = pic.mb_class == MB_I16
    if i16.any():
        dc_t = _np_hadamard4(_inv_scan_4x4(pic.luma_dc, fld))  # (n, 4, 4)
        scale = scale_y[:, 0, 0][:, None, None]
        dc_s = _rshift_rnd_sf((dc_t * scale) << per[:, None, None],
                              6).astype(np.int32)
        blk = np.arange(16)
        deq_dc = deq.copy()
        deq_dc[:, blk, 0, 0] = dc_s[:, blk // 4, blk % 4]
        deq = np.where(i16[:, None, None, None], deq_dc, deq)
    res_luma = ((_np_inv4(deq) + 32) >> 6).astype(np.int32)
    ll = lossless is not None and bool(np.any(lossless))
    if ll:
        ll_res = raster.astype(np.int32)
        if i16.any():
            blk = np.arange(16)
            ll_dc = ll_res.copy()
            ll_dc[:, blk, 0, 0] = _inv_scan_4x4(pic.luma_dc, fld)[
                :, blk // 4, blk % 4]
            ll_res = np.where(i16[:, None, None, None], ll_dc, ll_res)
        res_luma = np.where(lossless[:, None, None, None], ll_res, res_luma)

    # ---- luma of 8x8-transform MBs: intra -> list 6, inter -> list 7 ----
    t8 = np.asarray(pic.transform8x8)
    if t8.any():
        r8 = np.zeros((n, 4, 64), np.int64)
        r8[..., _ZZ8] = pic.luma_coef8
        scale8 = build_inv_scale8(pps)[np.where(intra, 0, 1), qp] \
            .astype(np.int64)                                   # (n, 8, 8)
        r8 = r8.reshape(n, 4, 8, 8)
        deq8 = _rshift_rnd_sf((r8 * scale8[:, None])
                              << per[:, None, None, None], 6)
        sp8 = (_np_inv8(deq8) + 32) >> 6
        if ll:
            sp8 = np.where(lossless[:, None, None, None], r8, sp8)
        res8 = split_8x8(sp8.astype(np.int32))
        res_luma = np.where(t8[:, None, None, None], res8, res_luma)

    # ---- chroma: lists 1 / 2 intra, 4 / 5 inter ----
    cbdo = 6 * (bd[1] - 8)                          # QpBdOffsetC
    qpc = np.array([[chroma_qp(int(q), pps.cb_qp_offset, bd[1]),
                     chroma_qp(int(q), pps.cr_qp_offset, bd[1])]
                    for q in pic.qp], np.int64).reshape(n, 2) + cbdo
    c_raster = _inv_scan_4x4(pic.chroma_coef, fld) \
        .astype(np.int64)                                       # (n,2,4,4,4)
    scale_c = np.stack([tab4[np.where(intra, 1, 4), qpc[:, 0]],
                        tab4[np.where(intra, 2, 5), qpc[:, 1]]],
                       axis=1).astype(np.int64)                 # (n, 2, 4, 4)
    perc = qpc // 6
    c_deq = _rshift_rnd_sf((c_raster * scale_c[:, :, None])
                           << perc[:, :, None, None, None], 4).astype(np.int32)
    if pic.n_crows == 2:
        # chroma DC: 2x2 Hadamard, then scale (floor >> 5)
        dc = pic.chroma_dc.reshape(n, 2, 2, 2).astype(np.int64)
        a, b = dc[..., 0, 0], dc[..., 0, 1]
        c, d = dc[..., 1, 0], dc[..., 1, 1]
        f = np.stack([
            np.stack([a + b + c + d, a - b + c - d], axis=-1),
            np.stack([a + b - c - d, a - b - c + d], axis=-1)], axis=-2)
        dc_s = (((f * scale_c[:, :, 0, 0][..., None, None])
                 << perc[..., None, None]) >> 5).astype(np.int32)
        blk = np.arange(4)
        c_deq[:, :, blk, 0, 0] = dc_s[:, :, blk // 2, blk % 2]
    else:
        # 4:2:2 chroma DC: the 2x4 Hadamard, scaled at QPc + 3 with a
        # rounded >> 6
        f = _np_ihadamard2x4(pic.chroma_dc)                 # [column][row]
        qpdc = qpc + 3
        scale_dc = np.stack([tab4[np.where(intra, 1, 4), qpdc[:, 0]],
                             tab4[np.where(intra, 2, 5), qpdc[:, 1]]],
                            axis=1)[:, :, 0, 0].astype(np.int64)
        dc_s = _rshift_rnd_sf((f * scale_dc[..., None, None])
                              << (qpdc // 6)[..., None, None],
                              6).astype(np.int32)
        for j in range(4):
            for i in range(2):
                c_deq[:, :, 2 * j + i, 0, 0] = dc_s[:, :, i, j]
    res_chroma = ((_np_inv4(c_deq) + 32) >> 6).astype(np.int32)
    if ll:
        ll_c = c_raster.astype(np.int32)
        if pic.n_crows == 2:
            ll_c[:, :, :, 0, 0] = pic.chroma_dc
        else:
            # column-major 2x4 placement (ldecod read_comp_cavlc.c:1468)
            for k, (i, j) in enumerate(SCAN_YUV422):
                ll_c[:, :, 2 * j + i, 0, 0] = pic.chroma_dc[:, :, k]
        res_chroma = np.where(lossless[:, None, None, None, None], ll_c,
                              res_chroma)
    return res_luma, res_chroma


class Reconstructor:
    """Host reconstruction of one picture's intra and I_PCM macroblocks.
    bd: the (luma, chroma) bit depths; bypass: the SPS's
    qpprime_y_zero_transform_bypass_flag, which makes the MBs of QP'Y 0
    lossless (ldecod macroblock.c:196, jm_tpu recon.py:352-355)."""

    def __init__(self, pic: PictureData, pps, bd=(8, 8), bypass=False):
        self.pic = pic
        self.pps = pps
        self.bd = bd
        self.mb_w = pic.mb_w
        self.w = pic.mb_w * 16
        self.h = pic.mb_h * 16
        self.ch = 4 * pic.n_crows                 # chroma MB height: 8 or 16
        self.maxY, self.maxC = (1 << bd[0]) - 1, (1 << bd[1]) - 1
        self.dcY, self.dcC = 1 << (bd[0] - 1), 1 << (bd[1] - 1)
        self.ll = (pic.qp + 6 * (bd[0] - 8) == 0) if bypass \
            else np.zeros(pic.n_mbs, bool)
        dt = np.uint8 if bd == (8, 8) else np.uint16
        self.Y = np.zeros((self.h, self.w), dt)
        self.U = np.zeros((self.ch * pic.mb_h, self.w // 2), dt)
        self.V = np.zeros((self.ch * pic.mb_h, self.w // 2), dt)

    # ---- availability (same slice, already decoded) -----------------------

    def _mb_avail(self, naddr: int, addr: int) -> bool:
        if naddr < 0 or naddr >= self.pic.n_mbs:
            return False
        return self.pic.slice_id[naddr] == self.pic.slice_id[addr]

    def _block_avail(self, addr, gbx, gby, cur_code) -> bool:
        """Availability of the 4x4 luma block at global block coordinates
        for intra prediction of block cur_code (coding order) of MB addr."""
        if gbx < 0 or gby < 0 or gbx >= self.mb_w * 4:
            return False
        naddr = (gby // 4) * self.mb_w + (gbx // 4)
        if naddr == addr:
            return RASTER2CODE[(gby % 4) * 4 + (gbx % 4)] < cur_code
        if naddr > addr:
            return False
        return self._mb_avail(naddr, addr)

    # ---- reconstruction ---------------------------------------------------

    def run(self, seed=None, native: bool = True
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """seed: (Y, U, V) planes holding the inter MBs (ops/dec
        .inter_recon_p), required when the picture has any. Returns the
        (Y, U, V) planes, not yet deblocked."""
        pic = self.pic
        if seed is not None:
            self.Y[:], self.U[:], self.V[:] = seed
        elif (pic.mb_class == MB_INTER).any():
            raise ValueError("inter macroblocks need the device seed planes")
        res_l, res_c = decode_residuals(pic, self.pps, self.bd, self.ll)
        if native and self.bd == (8, 8) and not self.ll.any() \
                and not (pic.mb_class == MB_IPCM).any():
            N.routes["recon"]["native"] += 1
            N.load().intra_recon(
                {"mb_w": pic.mb_w, "mb_h": pic.mb_h, "crows": pic.n_crows},
                {"Y": self.Y, "U": self.U, "V": self.V,
                 "mb_class": pic.mb_class, "transform8x8": pic.transform8x8,
                 "i4_modes": pic.i4_modes, "i16_mode": pic.i16_mode,
                 "chroma_mode": pic.chroma_mode, "slice_id": pic.slice_id,
                 "res_l": res_l, "res_c": res_c})
            return self.Y, self.U, self.V
        N.routes["recon"]["python"] += 1
        for addr in range(pic.n_mbs):
            cls = pic.mb_class[addr]
            if cls == MB_I16:
                self._recon_i16(addr, res_l, res_c)
            elif cls == MB_I4 and pic.transform8x8[addr]:
                self._recon_i8(addr, res_l, res_c)
            elif cls == MB_I4:
                self._recon_i4(addr, res_l, res_c)
            elif cls == MB_IPCM:
                self._recon_ipcm(addr)
        return self.Y, self.U, self.V

    def _recon_i4(self, addr, res_l, res_c):
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        Y = self.Y
        for code in range(16):
            by, bx = divmod(int(CODE2RASTER[code]), 4)
            gx, gy = mbx * 4 + bx, mby * 4 + by
            x, y = gx * 4, gy * 4
            avail_l = self._block_avail(addr, gx - 1, gy, code)
            avail_t = self._block_avail(addr, gx, gy - 1, code)
            avail_tl = self._block_avail(addr, gx - 1, gy - 1, code)
            avail_tr = self._block_avail(addr, gx + 1, gy - 1, code)
            top = np.zeros(8, np.int32)
            left = np.zeros(4, np.int32)
            corner = 0
            if avail_t:
                top[0:4] = Y[y - 1, x:x + 4]
                if avail_tr:
                    top[4:8] = Y[y - 1, x + 4:x + 8]
                else:
                    top[4:8] = Y[y - 1, x + 3]
            if avail_l:
                left[:] = Y[y:y + 4, x - 1]
            if avail_tl:
                corner = int(Y[y - 1, x - 1])
            mode = int(pic.i4_modes[addr, by * 4 + bx])
            pred = I.predict_i4(mode, top, left, corner, avail_t, avail_l,
                                dc=self.dcY)
            res = self._dpcm(addr, res_l[addr, by * 4 + bx], mode)
            Y[y:y + 4, x:x + 4] = np.clip(pred + res, 0, self.maxY)
        self._recon_chroma_intra(addr, res_c)

    def _recon_i8(self, addr, res_l, res_c):
        """Intra 8x8: the four quadrants in order, each predicted from
        the filtered reference samples (intra_pred.predict_i8); the
        up-right samples of quadrant 1 come from the MB above right, of
        quadrant 3 never (jm_tpu/decoder/recon.py _recon_i8)."""
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        Y = self.Y
        for q in range(4):
            by, bx = (q // 2) * 2, (q % 2) * 2     # its top-left 4x4
            gx, gy = mbx * 4 + bx, mby * 4 + by
            x, y = gx * 4, gy * 4
            code = int(RASTER2CODE[by * 4 + bx])
            avail_l = self._block_avail(addr, gx - 1, gy, code)
            avail_t = self._block_avail(addr, gx, gy - 1, code)
            avail_tl = self._block_avail(addr, gx - 1, gy - 1, code)
            avail_tr = self._block_avail(addr, gx + 2, gy - 1, code)
            top = np.zeros(16, np.int32)
            left = np.zeros(8, np.int32)
            corner = 0
            if avail_t:
                top[0:8] = Y[y - 1, x:x + 8]
                top[8:16] = Y[y - 1, x + 8:x + 16] if avail_tr \
                    else Y[y - 1, x + 7]
            if avail_l:
                left[:] = Y[y:y + 8, x - 1]
            if avail_tl:
                corner = int(Y[y - 1, x - 1])
            mode = int(pic.i4_modes[addr, by * 4 + bx])
            pred = I.predict_i8(mode, top, left, corner, avail_t, avail_l,
                                avail_tl, dc=self.dcY)
            blks = [(by + dy) * 4 + bx + dx for dy in (0, 1) for dx in (0, 1)]
            res = res_l[addr, blks].reshape(2, 2, 4, 4).transpose(
                0, 2, 1, 3).reshape(8, 8)
            res = self._dpcm(addr, res, mode)
            Y[y:y + 8, x:x + 8] = np.clip(pred + res, 0, self.maxY)
        self._recon_chroma_intra(addr, res_c)

    def _recon_i16(self, addr, res_l, res_c):
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        Y = self.Y
        avail_l = self._mb_avail(addr - 1, addr) if mbx > 0 else False
        avail_t = self._mb_avail(addr - self.mb_w, addr)
        avail_tl = (mbx > 0) and self._mb_avail(addr - self.mb_w - 1, addr)
        top = Y[py - 1, px:px + 16].astype(np.int32) if avail_t \
            else np.zeros(16, np.int32)
        left = Y[py:py + 16, px - 1].astype(np.int32) if avail_l \
            else np.zeros(16, np.int32)
        corner = int(Y[py - 1, px - 1]) if avail_tl else 0
        mode = int(pic.i16_mode[addr])
        pred = I.predict_i16(mode, top, left, corner, avail_t, avail_l,
                             dc=self.dcY, cmax=self.maxY)
        res = res_l[addr].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 16)
        res = self._dpcm(addr, res, mode)
        Y[py:py + 16, px:px + 16] = np.clip(pred + res, 0, self.maxY)
        self._recon_chroma_intra(addr, res_c)

    def _recon_chroma_intra(self, addr, res_c):
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        ch = self.ch
        cx, cy = mbx * 8, mby * ch
        avail_l = self._mb_avail(addr - 1, addr) if mbx > 0 else False
        avail_t = self._mb_avail(addr - self.mb_w, addr)
        avail_tl = (mbx > 0) and self._mb_avail(addr - self.mb_w - 1, addr)
        mode = int(self.pic.chroma_mode[addr])
        for comp, plane in ((0, self.U), (1, self.V)):
            top = plane[cy - 1, cx:cx + 8].astype(np.int32) if avail_t \
                else np.zeros(8, np.int32)
            left = plane[cy:cy + ch, cx - 1].astype(np.int32) if avail_l \
                else np.zeros(ch, np.int32)
            corner = int(plane[cy - 1, cx - 1]) if avail_tl else 0
            pred = I.predict_chroma(mode, top, left, corner, avail_t,
                                    avail_l, dc=self.dcC, cmax=self.maxC)
            res = res_c[addr, comp].reshape(ch // 4, 2, 4, 4) \
                .transpose(0, 2, 1, 3).reshape(ch, 8)
            # chroma modes: 1 horizontal, 2 vertical (luma: 0 / 1)
            res = self._dpcm(addr, res, {1: 1, 2: 0}.get(mode, -1))
            plane[cy:cy + ch, cx:cx + 8] = np.clip(pred + res, 0, self.maxC)

    def _dpcm(self, addr, res, mode: int):
        """The residual of a block predicted in ``mode`` (luma numbering:
        0 vertical, 1 horizontal): a lossless MB's vertical / horizontal
        prediction adds the residual up down the columns / along the rows
        (spec 8.5.15; jm_tpu recon.py:491, 535, 556, 580)."""
        if not self.ll[addr] or mode not in (0, 1):
            return res
        return np.cumsum(res, axis=0 if mode == 0 else 1)

    def _recon_ipcm(self, addr):
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        self.Y[mby * 16:mby * 16 + 16, mbx * 16:mbx * 16 + 16] = \
            pic.ipcm_luma[addr]
        c, ch = pic.ipcm_chroma[addr], self.ch
        self.U[mby * ch:mby * ch + ch, mbx * 8:mbx * 8 + 8] = c[0]
        self.V[mby * ch:mby * ch + ch, mbx * 8:mbx * 8 + 8] = c[1]
