"""H.264 encoder of the port: IPPP, 4:2:0, one slice, one reference,
fixed QP, with the trial-encode RD P path (device_rd) or md_low, CAVLC
(Baseline) or CABAC (Main) (twin of jm_tpu.encoder.Encoder with
pipeline="device": its pipelined ``encode_stream`` and its per-frame
``encode_frame``).

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
per P frame is the download of its packed words. The pipe speculates
that every MB is inter. When frame N's intra trigger fired (a scene cut),
it is finished on the per-frame path with its device encode reused, and
frame N+1 is dispatched again against the corrected reference.

The per-frame path (``encode_frame``, and every frame when
intra_mb_refresh > 0 or with CABAC): ops/enc.p_frame_step on the device,
the download of its fields, the host commit with the serial re-encode of
the intra MBs (encoder/p_intra.py), boundary strengths + deblock +
reference prep on the device, and the host serializer.

With entropy="cabac" the device path and its decisions are the same;
only the host serializer changes (encoder/syntax_cabac.py, with the
cabac_init_idc of each P slice the shortest of the three when
cabac_adapt_init is set, and the cabac_zero_words of clause 7.4.2.10).

The encoder runs on CUDA unless the caller passes device="cpu"; without a
card a CUDA request raises.
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
from .p_intra import CORE_FIELDS, PictureCommit
from .syntax import serialize_slice, write_pps, write_slice_header, write_sps
from .syntax_cabac import serialize_slice_cabac


def lambda_me(qp: int) -> int:
    """JM md_low lambda in the SAD domain: sqrt(0.85 * 2^((QP-12)/3))."""
    return max(1, int(round((0.85 * 2.0 ** ((qp - 12) / 3.0)) ** 0.5)))


def lambda_mode4(qp: int) -> int:
    """Penalty unit for non-most-probable intra-4x4 modes (4 lambda_me)."""
    return 4 * lambda_me(qp)


@dataclass
class EncoderConfig:
    """The configurations this encoder covers: jm_tpu's device IPPP set
    (4:2:0, one slice, one reference, fixed QP, deblocking on), with
    device RD or md_low, CAVLC or CABAC, and random intra refresh. Values
    outside it raise ValueError."""
    width: int = 176
    height: int = 144
    qp: int = 28
    intra_period: int = 0        # 0: only the first frame is an IDR
    search_range: int = 16       # integer full search +-SR (<= 24)
    level_idc: int = 30          # raised to the smallest level that fits
    frame_rate: float = 30.0
    device_rd: bool = True       # trial-encode RD mode decision; False:
                                 # md_low's cost-based decision
    intra_mb_refresh: int = 0    # forced-intra MBs per P picture (lencod
                                 # RandomIntraMBRefresh, intrarefresh.c)
    entropy: str = "cavlc"       # "cavlc" (Baseline) | "cabac" (Main)
    cabac_adapt_init: bool = False   # per P slice, the shortest of the 3
                                 # cabac_init_idc models (lencod
                                 # ContextInitMethod = 1)


def _check_config(cfg: EncoderConfig) -> None:
    for name in ("device_rd", "cabac_adapt_init"):
        if not isinstance(getattr(cfg, name), bool):
            raise ValueError(f"EncoderConfig.{name}="
                             f"{getattr(cfg, name)!r}: True or False")
    if cfg.entropy not in ("cavlc", "cabac"):
        raise ValueError(f"EncoderConfig.entropy={cfg.entropy!r}: "
                         "'cavlc' or 'cabac'")
    if cfg.intra_mb_refresh < 0:
        raise ValueError(f"EncoderConfig.intra_mb_refresh="
                         f"{cfg.intra_mb_refresh}: must be >= 0")
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
    per frame, as ``encode_frame(Y, U, V)`` does frame by frame.
    ``results`` holds one dict per coded picture (disp, type, bits, qp,
    frame: a Picture with the deblocked recon; intra_mbs: the MBs coded
    intra, for P frames of the per-frame path; cabac_init_idc: the
    context model of a CABAC P slice)."""

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
        cabac = cfg.entropy == "cabac"
        self.sps = SPS(
            profile_idc=77 if cabac else 66, level_idc=level, log2_max_frame_num_minus4=4,
            pic_order_cnt_type=0, log2_max_pic_order_cnt_lsb_minus4=4,
            max_num_ref_frames=1,
            pic_width_in_mbs_minus1=self.mb_w - 1,
            pic_height_in_map_units_minus1=self.mb_h - 1,
            chroma_format_idc=1, frame_mbs_only_flag=1,
            direct_8x8_inference_flag=1)
        self.pps = PPS(num_ref_idx_l0_default_active_minus1=0,
                       entropy_coding_mode_flag=1 if cabac else 0,
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
        # display indices of the P frames finished on the per-frame path
        # after the pipe's intra speculation failed, and the dispatches
        # repeated against the corrected reference; display indices of
        # the P frames serialized on the host because the packer
        # overflowed
        self.fallbacks = []
        self.redispatches = 0
        self.ovf = []
        # random intra refresh (intrarefresh.c RandomIntraInit): a seeded
        # permutation of MB addresses taken intra_mb_refresh at a time
        self._refresh_perm = []
        self._refresh_pos = 0
        self._refresh_rng = np.random.default_rng(1)

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

    def _planes(self, packed):
        """The (Y, U, V) views of an uploaded packed frame."""
        h, cw = 16 * self.mb_h, 8 * self.mb_w
        return packed[:h], packed[h:, :cw], packed[h:, cw:]

    def _idr_due(self, idx: int) -> bool:
        ip = self.cfg.intra_period
        return idx == 0 or (ip > 0 and idx % ip == 0)

    def encode_stream(self, frames) -> list:
        """Encode (Y, U, V) display-order frames; returns the per-frame
        Annex-B payloads (bytes). With intra_mb_refresh > 0 or CABAC every
        frame takes the per-frame path (as jm_tpu's does: its pipe packs
        CAVLC only)."""
        if self.cfg.intra_mb_refresh > 0 or self.cfg.entropy == "cabac":
            return [self.encode_frame(*f) for f in frames]
        payloads = []
        pending = None       # (out, disp, state, frame) of the dispatched P
        state = None         # reference for the next dispatch
        for f in frames:
            packed = self._upload(f)
            idx = self.frame_idx + (1 if pending is not None else 0)
            if self._idr_due(idx) or (self.ref_state is None
                                      and pending is None):
                if pending is not None:
                    payloads.append(self._finalize(*pending)[0])
                    pending = None
                payloads.append(self._encode_idr(*self._planes(packed)))
                state = None
                continue
            disp = self.display_idx
            self.display_idx += 1
            out, new_state = self._dispatch(
                packed, state if state is not None else self.ref_state)
            if pending is not None:
                payload, fell_back = self._finalize(*pending)
                payloads.append(payload)
                if fell_back:
                    # frame N+1 was speculated against frame N's all-inter
                    # recon: dispatch it again against the corrected one
                    self.redispatches += 1
                    out, new_state = self._dispatch(packed, self.ref_state)
            pending = (out, disp, new_state, f)
            state = new_state
        if pending is not None:
            payloads.append(self._finalize(*pending)[0])
        return payloads

    def encode_frame(self, Y, U, V) -> bytes:
        """Encode one display-order frame on the per-frame path and return
        its Annex-B payload (there are no B pictures, so nothing is held
        back)."""
        cfg = self.cfg
        packed = self._upload((Y, U, V))
        if self._idr_due(self.frame_idx):
            return self._encode_idr(*self._planes(packed))
        disp = self.display_idx
        self.display_idx += 1
        forced = self._refresh_set()
        core = E.p_frame_step(
            *self._planes(packed), *self.ref_state, cfg.qp, self.qpc,
            lambda_me(cfg.qp), lambda_mode4(cfg.qp), mb_w=self.mb_w,
            mb_h=self.mb_h, sr=cfg.search_range, rd=cfg.device_rd)
        return self._finish_p(core, disp, (Y, U, V), forced)

    def flush(self) -> bytes:
        """The end of the stream: nothing is buffered (no B pictures)."""
        return b""

    def _refresh_set(self) -> set:
        """The next intra_mb_refresh MBs of the refresh permutation."""
        k = self.cfg.intra_mb_refresh
        n = self.mb_w * self.mb_h
        out = set()
        while len(out) < min(k, n):
            if self._refresh_pos >= len(self._refresh_perm):
                self._refresh_perm = list(self._refresh_rng.permutation(n))
                self._refresh_pos = 0
            out.add(int(self._refresh_perm[self._refresh_pos]))
            self._refresh_pos += 1
        return out

    def _dispatch(self, packed, ref):
        """The pipe of one P frame against the reference state ref."""
        cfg = self.cfg
        return E.p_frame_rd_pipe(
            packed, *ref, cfg.qp, self.qpc, lambda_me(cfg.qp),
            lambda_mode4(cfg.qp), self.qpc_cb, self.qpc_cr, mb_w=self.mb_w,
            mb_h=self.mb_h, sr=cfg.search_range, max_words=self.max_words,
            rd=cfg.device_rd)

    # ------------------------------------------------------------------

    def _deblock(self, rec, mb_class, luma_nnz, mv=None, ref_pic_id=None):
        """Boundary strengths + deblock of a picture (device tensors):
        mb_class (N,) (0 inter), luma_nnz (N, 16), and for P pictures the
        MVs (N, 16, 2) and reference ids (N, 4) (-1 for intra MBs)."""
        n = self.mb_w * self.mb_h
        dev = self.device
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        if mv is None:
            mv = torch.zeros((n, 16, 2), dtype=torch.int32, device=dev)
            ref_pic_id = torch.full((n, 4), -1, dtype=torch.int32, device=dev)
        bs_v, bs_h = compute_bs(mb_class, luma_nnz, zeros, mv,
                                torch.zeros_like(mv),
                                ref_pic_id, torch.full_like(ref_pic_id, -1),
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
        dY, dU, dV = self._deblock(
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
        nal, _info = self._slice_nal(pic, SliceType.I, 0)
        payload = (annexb_bytes(3, NalUnitType.SPS, write_sps(self.sps))
                   + annexb_bytes(3, NalUnitType.PPS, write_pps(self.pps))
                   + nal)
        frame = Picture(0, 0, planes=tuple(t.cpu().numpy()
                                           for t in (dY, dU, dV)))
        self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        self.results.append({"disp": disp, "type": "I",
                             "bits": len(payload) * 8, "frame": frame,
                             "qp": qp})
        return payload

    def _finalize(self, out, disp: int, new_state, frame):
        """Complete a dispatched P frame: download its packed words and
        prepend the slice header, or serialize it on the host when the
        packer overflowed. When its intra trigger fired, finish it on the
        per-frame path with the dispatched encode reused. Returns
        (payload, whether it fell back)."""
        ext = out["words_ext"].cpu().numpy()
        nbits, ovf, intra_any = (int(v) for v in ext[:3])
        if intra_any:
            self.fallbacks.append(disp)
            return self._finish_p(out["core"], disp, frame, ()), True
        if ovf:
            self.ovf.append(disp)
            nal, info = self._serialize_p(self._inter_picture(out), disp)
        else:
            k = (nbits + 31) // 32
            bw = BitWriter()
            write_slice_header(bw, self.sps, self.pps,
                               slice_type=SliceType.P,
                               frame_num=self.frame_num, idr=False,
                               idr_pic_id=self.idr_pic_id, qp=self.cfg.qp,
                               poc_lsb=2 * (disp - self._idr_disp) % 256)
            bw.append_bitstream(ext[3:3 + k].astype(">u4").tobytes(), nbits)
            bw.rbsp_trailing_bits()
            nal, info = annexb_bytes(3, NalUnitType.SLICE, bw.get_bytes()), {}
        return self._commit_p_frame(nal, disp, new_state, **info), False

    def _commit_p_frame(self, slice_bytes: bytes, disp: int, state,
                        **info) -> bytes:
        """Store a coded P picture (its slice NAL unit slice_bytes) as the
        reference and in ``results`` (with the items of info); returns
        slice_bytes."""
        poc = 2 * (disp - self._idr_disp)
        self.ref_state = state
        frame = Picture(poc, self.frame_num, state=state)
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        self.results.append({"disp": disp, "type": "P",
                             "bits": len(slice_bytes) * 8, "frame": frame,
                             "qp": self.cfg.qp, **info})
        return slice_bytes

    # ---- the per-frame P path ----------------------------------------

    def _finish_p(self, core, disp: int, frame, forced) -> bytes:
        """The per-frame P path after the device encode `core`
        (p_frame_step's fields): download, host commit with the intra
        re-encode, deblock and reference prep on the device, host
        serializer. frame: the source (Y, U, V) planes; forced: MBs of
        the intra refresh."""
        c = self._commit_p(self._download_core(core), frame, forced)
        state = self._deblock_p(c)
        nal, info = self._serialize_p(c.pic, disp)
        return self._commit_p_frame(nal, disp, state,
                                    intra_mbs=len(c.intra_mbs), **info)

    def _download_core(self, core) -> dict:
        return {k: core[k].cpu().numpy() for k in CORE_FIELDS}

    def _commit_p(self, core, frame, forced) -> PictureCommit:
        return PictureCommit(core, frame, self.cfg.qp, self.qpc, forced)

    def _deblock_p(self, c: PictureCommit):
        """The committed picture's boundary strengths, deblock and
        reference prep on the device; returns the reference state."""
        pic = c.pic

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        return E.prep_ref(*self._deblock(
            tuple(up(p) for p in (c.recY, c.recU, c.recV)), up(pic.mb_class),
            up(pic.luma_nnz), up(pic.mv), up(pic.ref_pic_id)))

    def _serialize_p(self, pic: PictureData, disp: int):
        """A P picture as one slice serialized on the host: (its NAL
        unit, what ``results`` records of it)."""
        return self._slice_nal(pic, SliceType.P,
                               2 * (disp - self._idr_disp) % 256)

    def _slice_nal(self, pic: PictureData, slice_type: SliceType,
                   poc_lsb: int):
        """The picture as one slice NAL unit (an IDR for I slices), CAVLC
        or CABAC; with CABAC followed by the cabac_zero_words its bin count
        calls for. Returns (bytes, {"cabac_init_idc": idc} for a CABAC P
        slice, else {})."""
        idr = slice_type == SliceType.I
        kw = dict(slice_type=slice_type, frame_num=self.frame_num, idr=idr,
                  qp=self.cfg.qp, poc_lsb=poc_lsb,
                  idr_pic_id=self.idr_pic_id)
        nal_type = NalUnitType.IDR if idr else NalUnitType.SLICE
        if self.cfg.entropy == "cavlc":
            rbsp = serialize_slice(pic, self.sps, self.pps, **kw)
            return annexb_bytes(3, nal_type, rbsp), {}
        rbsp, bins, idc = self._serialize_cabac_best_init(pic, **kw)
        nal = annexb_bytes(3, nal_type, rbsp)
        return (nal + self._cabac_zero_words(nal, bins),
                {} if idr else {"cabac_init_idc": idc})

    def _serialize_cabac_best_init(self, pic: PictureData, **kw):
        """CABAC slice with the context model of lencod's
        ContextInitMethod = 1 when cabac_adapt_init is set: each P slice
        is serialized under the three models and the shortest kept (the
        first on a tie), as jm_tpu's exact version of JM's estimate does
        (encoder.py _serialize_cabac_best_init). Returns (RBSP, bins
        coded, cabac_init_idc)."""
        stats = {}
        if kw["slice_type"] == SliceType.I or not self.cfg.cabac_adapt_init:
            rbsp = serialize_slice_cabac(pic, self.sps, self.pps,
                                         stats=stats, **kw)
            return rbsp, stats["bins"], 0
        best = None
        for idc in range(3):
            rbsp = serialize_slice_cabac(pic, self.sps, self.pps,
                                         cabac_init_idc=idc, stats=stats,
                                         **kw)
            if best is None or len(rbsp) < len(best[0]):
                best = (rbsp, stats["bins"], idc)
        return best

    def _cabac_zero_words(self, nal: bytes, bins: int) -> bytes:
        """Clause 7.4.2.10: cabac_zero_words (EBSP 00 00 03) after the
        picture's slice NAL unit when the bins coded exceed what its size
        allows (lencod/src/nal.c addCabacZeroWords; jm_tpu encoder.py
        _cabac_zero_words). RawMbBits of 8-bit 4:2:0 is 3072."""
        n_mbs = self.mb_w * self.mb_h
        min_bytes = (96 * bins - 3072 * n_mbs * 3 + 1023) // 1024
        vcl_bytes = len(nal) - 3       # NAL header + EBSP, as JM counts
        if min_bytes <= vcl_bytes:
            return b""
        return b"\x00\x00\x03" * ((min_bytes - vcl_bytes + 2) // 3)

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
