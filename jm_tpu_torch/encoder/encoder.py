"""Baseline H.264 encoder of the port: IPPP, CAVLC, 4:2:0, one slice,
one reference, fixed QP, with the trial-encode RD P path (twin of
jm_tpu.encoder.Encoder on its pipelined ``encode_stream`` fast path).

Per stream:
  - IDR frames: ops/intra.i_frame_step on the device, then boundary
    strengths + deblock (the CUDA kernels on the card), then the host
    CAVLC serializer (encoder/syntax.py) with SPS / PPS;
  - P frames: ops/enc.p_frame_rd_pipe, one call per frame that leaves
    the packed CAVLC words, the decisions and the next reference state on
    the device. The host prepends the slice header to the words. When the
    packer flags an overflow (ovf) the frame is serialized on the host
    from the downloaded decisions instead.

Frame N+1 is dispatched before frame N is finalized; the only host sync
per P frame is the download of its packed words.

The encoder runs on CUDA unless the caller passes device="cpu"; without a
card a CUDA request raises. P frames whose intra trigger fires need the
host intra re-encode of jm_tpu (encoder.py _encode_p_device), which is
not ported yet: they raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.bitwriter import BitWriter
from ..bitstream.nal import NalUnitType, annexb_bytes
from ..common.conformance import level_check, minimum_level
from ..common.picture import MB_INTER, PictureData
from ..common.tables import chroma_qp
from ..common.types import PPS, SPS, SliceType
from ..convert import qpc_tables
from ..device import resolve
from ..ops import enc as E
from ..ops.deblock import compute_bs, deblock
from ..ops.intra import i_frame_step
from .syntax import serialize_slice, write_pps, write_slice_header, write_sps


def lambda_me(qp: int) -> int:
    """JM md_low lambda in the SAD domain: sqrt(0.85 * 2^((QP-12)/3))."""
    return max(1, int(round((0.85 * 2.0 ** ((qp - 12) / 3.0)) ** 0.5)))


def lambda_mode4(qp: int) -> int:
    """Penalty unit for non-most-probable intra-4x4 modes (4 lambda_me)."""
    return 4 * lambda_me(qp)


@dataclass
class EncoderConfig:
    """The configurations this encoder covers: jm_tpu's pipelined IPPP
    set (CAVLC, 4:2:0, one slice, one reference, fixed QP, deblocking on)
    with device RD. Values outside it raise ValueError."""
    width: int = 176
    height: int = 144
    qp: int = 28
    intra_period: int = 0        # 0: only the first frame is an IDR
    search_range: int = 16       # integer full search +-SR (<= 24)
    level_idc: int = 30          # raised to the smallest level that fits
    frame_rate: float = 30.0
    device_rd: bool = True       # trial-encode RD mode decision


def _check_config(cfg: EncoderConfig) -> None:
    if cfg.device_rd is not True:
        raise ValueError(f"EncoderConfig.device_rd={cfg.device_rd!r}: only "
                         "the RD P path (True) is ported")
    if cfg.width <= 0 or cfg.height <= 0 or cfg.width % 16 \
            or cfg.height % 16:
        raise ValueError(f"EncoderConfig.width/height {cfg.width}x"
                         f"{cfg.height}: positive multiples of 16 only")
    if not 0 <= cfg.qp <= 51:
        raise ValueError(f"EncoderConfig.qp={cfg.qp}: outside 0..51")
    if cfg.intra_period < 0:
        raise ValueError(f"EncoderConfig.intra_period={cfg.intra_period}: "
                         "must be >= 0")
    if not 0 < cfg.search_range <= 24:
        raise ValueError(f"EncoderConfig.search_range={cfg.search_range}: "
                         "1..24 only")


class Picture:
    """A coded picture's deblocked reconstruction. Y / U / V are numpy
    uint8 planes, downloaded from the device reference state on first
    access (P frames) or given (IDR frames)."""

    def __init__(self, poc: int, frame_num: int, state=None, planes=None):
        self.poc = poc
        self.frame_num = frame_num
        self._state = state
        self._planes = planes

    def _materialize(self):
        if self._planes is None:
            p = E.PAD
            planes, padU, padV = self._state
            self._planes = tuple(t.cpu().numpy()[p:-p, p:-p]
                                 for t in (planes[0], padU, padV))
        return self._planes

    @property
    def Y(self):
        return self._materialize()[0]

    @property
    def U(self):
        return self._materialize()[1]

    @property
    def V(self):
        return self._materialize()[2]


class Encoder:
    """IPPP encoder: ``encode_stream(frames)`` returns one Annex-B payload
    per frame. ``results`` holds one dict per coded picture (disp, type,
    bits, qp, frame: a Picture with the deblocked recon)."""

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        _check_config(cfg)
        self.cfg = cfg
        self.device = resolve(device, "Encoder")
        self.mb_w = cfg.width // 16
        self.mb_h = cfg.height // 16
        try:
            level_check(self.mb_w, self.mb_h, cfg.frame_rate, cfg.level_idc,
                        1)
            level = cfg.level_idc
        except ValueError:
            level = minimum_level(self.mb_w, self.mb_h, cfg.frame_rate, 1)
        self.sps = SPS(
            profile_idc=66, level_idc=level, log2_max_frame_num_minus4=4,
            pic_order_cnt_type=0, log2_max_pic_order_cnt_lsb_minus4=4,
            max_num_ref_frames=1,
            pic_width_in_mbs_minus1=self.mb_w - 1,
            pic_height_in_map_units_minus1=self.mb_h - 1,
            chroma_format_idc=1, frame_mbs_only_flag=1,
            direct_8x8_inference_flag=1)
        self.pps = PPS(num_ref_idx_l0_default_active_minus1=0,
                       entropy_coding_mode_flag=0,
                       deblocking_filter_control_present_flag=0)
        self.qpc = chroma_qp(cfg.qp, self.pps.chroma_qp_index_offset)
        self.qpc_cb, self.qpc_cr = qpc_tables(self.pps, self.device)
        n = self.mb_w * self.mb_h
        # packed-word budget (~96 bits per MB on average); hotter frames
        # raise ovf and are serialized on the host
        self.max_words = max(4096, n * 2) + 64
        self.frame_idx = 0            # coded pictures so far
        self.frame_num = 0
        self.idr_pic_id = 0
        self.display_idx = 0
        self._idr_disp = 0
        self.ref_state = None         # the DPB: the last picture's state
        self.results = []

    # ------------------------------------------------------------------

    def _upload(self, frame) -> torch.Tensor:
        """Y on top, U | V side by side below, in one host buffer and one
        copy to the device."""
        Y, U, V = (np.asarray(p, np.uint8) for p in frame)
        if Y.shape != (16 * self.mb_h, 16 * self.mb_w) \
                or U.shape != (8 * self.mb_h, 8 * self.mb_w) \
                or V.shape != U.shape:
            raise ValueError(f"frame planes {Y.shape}/{U.shape}/{V.shape} "
                             f"do not match {self.cfg.width}x"
                             f"{self.cfg.height} 4:2:0")
        buf = np.empty((Y.shape[0] + U.shape[0], Y.shape[1]), np.uint8)
        buf[:Y.shape[0]] = Y
        buf[Y.shape[0]:, :U.shape[1]] = U
        buf[Y.shape[0]:, U.shape[1]:] = V
        t = torch.from_numpy(buf)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def encode_stream(self, frames) -> list:
        """Encode (Y, U, V) display-order frames; returns the per-frame
        Annex-B payloads (bytes)."""
        cfg = self.cfg
        h = 16 * self.mb_h
        payloads = []
        pending = None       # (out, disp, state) of the dispatched P frame
        state = None         # reference for the next dispatch
        for f in frames:
            packed = self._upload(f)
            idx = self.frame_idx + (1 if pending is not None else 0)
            intra_due = cfg.intra_period > 0 and idx % cfg.intra_period == 0
            if idx == 0 or intra_due or (self.ref_state is None
                                         and pending is None):
                if pending is not None:
                    payloads.append(self._finalize(*pending))
                    pending = None
                payloads.append(self._encode_idr(
                    packed[:h], packed[h:, :8 * self.mb_w],
                    packed[h:, 8 * self.mb_w:]))
                state = None
                continue
            disp = self.display_idx
            self.display_idx += 1
            ref = state if state is not None else self.ref_state
            out, new_state = E.p_frame_rd_pipe(
                packed, *ref, cfg.qp, self.qpc, lambda_me(cfg.qp),
                lambda_mode4(cfg.qp), self.qpc_cb, self.qpc_cr,
                mb_w=self.mb_w, mb_h=self.mb_h, sr=cfg.search_range,
                max_words=self.max_words)
            if pending is not None:
                payloads.append(self._finalize(*pending))
            pending = (out, disp, new_state)
            state = new_state
        if pending is not None:
            payloads.append(self._finalize(*pending))
        return payloads

    # ------------------------------------------------------------------

    def _deblock_intra(self, rec, cls, lnnz):
        """Boundary strengths + deblock of an all-intra picture."""
        n = self.mb_w * self.mb_h
        dev = self.device
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        zmv = torch.zeros((n, 16, 2), dtype=torch.int32, device=dev)
        noref = torch.full((n, 4), -1, dtype=torch.int32, device=dev)
        bs_v, bs_h = compute_bs(cls, lnnz, zeros, zmv, zmv, noref, noref,
                                self.mb_w, self.mb_h)
        qp_arr = torch.full((n,), self.cfg.qp, dtype=torch.int32, device=dev)
        return deblock(*rec, bs_v, bs_h, qp_arr, zeros, zeros, zeros, zeros,
                       zeros, self.qpc_cb, self.qpc_cr,
                       mb_w=self.mb_w, mb_h=self.mb_h)

    def _encode_idr(self, Y, U, V) -> bytes:
        cfg = self.cfg
        qp = cfg.qp
        disp = self.display_idx
        self.display_idx += 1
        self.frame_num = 0
        self._idr_disp = disp
        out = i_frame_step(Y, U, V, qp, self.qpc, lambda_me(qp),
                           lambda_mode4(qp), mb_w=self.mb_w, mb_h=self.mb_h)
        dY, dU, dV = self._deblock_intra(
            (out["recY"], out["recU"], out["recV"]), out["cls"], out["lnnz"])
        self.ref_state = E.prep_ref(dY, dU, dV)
        h = {k: out[k].cpu().numpy() for k in (
            "cls", "i4m", "i16m", "cmode", "cbp", "lcoef", "ldc", "lnnz",
            "cdc", "cac", "cnnz")}
        pic = PictureData(self.mb_w, self.mb_h)
        pic.mb_class[:] = h["cls"]
        pic.i4_modes[:] = h["i4m"]
        pic.i16_mode[:] = h["i16m"]
        pic.chroma_mode[:] = h["cmode"]
        pic.cbp[:] = h["cbp"]
        pic.luma_coef[:] = h["lcoef"]
        pic.luma_dc[:] = h["ldc"]
        pic.luma_nnz[:] = h["lnnz"]
        pic.chroma_dc[:] = h["cdc"]
        pic.chroma_coef[:] = h["cac"]
        pic.chroma_nnz[:] = h["cnnz"]
        pic.ref_idx[:] = -1
        pic.slice_id[:] = 0
        pic.qp[:] = qp
        rbsp = serialize_slice(pic, self.sps, self.pps,
                               slice_type=SliceType.I, frame_num=0, idr=True,
                               qp=qp, poc_lsb=0, idr_pic_id=self.idr_pic_id)
        payload = (annexb_bytes(3, NalUnitType.SPS, write_sps(self.sps))
                   + annexb_bytes(3, NalUnitType.PPS, write_pps(self.pps))
                   + annexb_bytes(3, NalUnitType.IDR, rbsp))
        frame = Picture(0, 0, planes=tuple(t.cpu().numpy()
                                           for t in (dY, dU, dV)))
        self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        self.results.append({"disp": disp, "type": "I",
                             "bits": len(payload) * 8, "frame": frame,
                             "qp": qp})
        return payload

    def _finalize(self, out, disp: int, new_state) -> bytes:
        """Complete a dispatched P frame: download its packed words and
        prepend the slice header, or serialize it on the host when the
        packer overflowed."""
        ext = out["words_ext"].cpu().numpy()
        nbits, ovf, intra_any = (int(v) for v in ext[:3])
        if intra_any:
            raise NotImplementedError(
                "intra speculation fallback: not yet ported")
        cfg = self.cfg
        qp = cfg.qp
        poc = 2 * (disp - self._idr_disp)
        if ovf:
            rbsp = serialize_slice(
                self._inter_picture(out), self.sps, self.pps,
                slice_type=SliceType.P, frame_num=self.frame_num, idr=False,
                qp=qp, poc_lsb=poc % 256, idr_pic_id=self.idr_pic_id)
        else:
            k = (nbits + 31) // 32
            bw = BitWriter()
            write_slice_header(bw, self.sps, self.pps,
                               slice_type=SliceType.P,
                               frame_num=self.frame_num, idr=False,
                               idr_pic_id=self.idr_pic_id, qp=qp,
                               poc_lsb=poc % 256)
            bw.append_bitstream(ext[3:3 + k].astype(">u4").tobytes(), nbits)
            bw.rbsp_trailing_bits()
            rbsp = bw.get_bytes()
        slice_bytes = annexb_bytes(3, NalUnitType.SLICE, rbsp)
        self.ref_state = new_state
        frame = Picture(poc, self.frame_num, state=new_state)
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        self.results.append({"disp": disp, "type": "P",
                             "bits": len(slice_bytes) * 8, "frame": frame,
                             "qp": qp})
        return slice_bytes

    def _inter_picture(self, out) -> PictureData:
        """The all-inter P picture's SoA state from the device decisions
        (for the host serializer)."""
        core = out["core"]
        o = {k: core[k].cpu().numpy() for k in (
            "inter_mode", "mv4", "luma_scan", "luma_nnz", "cbp",
            "chroma_dc", "chroma_scan", "chroma_nnz")}
        pic = PictureData(self.mb_w, self.mb_h)
        pic.mb_class[:] = MB_INTER
        pic.inter_mode[:] = o["inter_mode"]
        pic.mv[:] = o["mv4"]
        pic.ref_idx[:] = 0
        pic.luma_coef[:] = o["luma_scan"]
        pic.luma_nnz[:] = o["luma_nnz"]
        pic.chroma_dc[:] = o["chroma_dc"]
        pic.chroma_coef[:] = o["chroma_scan"]
        pic.chroma_nnz[:] = o["chroma_nnz"]
        pic.cbp[:] = o["cbp"]
        pic.qp[:] = self.cfg.qp
        pic.slice_id[:] = 0
        pic.skip[:] = out["skip"].cpu().numpy()
        return pic
