"""Top-level H.264 decoder of the port: Annex-B in, YUV frames out; twin
of jm_tpu.decoder.decoder.H264Decoder with ``device_recon=True``, for I
/ P / B streams, CAVLC (Baseline, Extended) or CABAC (Main, High, High
10, High 4:2:2, and the 4:2:0 streams of High 4:4:4 Predictive) (4:2:0
or 4:2:2 frame pictures of 8 to 14 bits, lossless macroblocks under
qpprime_y_zero_transform_bypass_flag, the 4x4 and the adaptive
8x8 transform with I8x8 prediction, flat or scaling-matrix
dequantization, one or more slices per picture, FMO slice groups of map
types 0-6, data-partitioned CAVLC slices (NAL units 2-4), redundant
pictures, list0 and list1 with several references, short- and long-term,
in a DPB with the sliding window or MMCO marking, spatial and temporal
direct prediction, explicit and implicit weighted prediction,
non-reference pictures, POC types 0, 1 and 2, the SP slices of the
Extended profile in CAVLC), and the field pictures of PAFF streams
(CAVLC I and P fields at 4:2:0 and 4:2:2, of 8 to 14 bits, and frame
pictures under an SPS that allows fields). Frames come out in decode
order, as jm_tpu's: callers sort them by POC; their planes are uint8 at
8 bits and uint16 above, as jm_tpu's.

Two phases per picture: the serial host parse of its slices
(decoder/mb_parse.py for CAVLC, decoder/mb_parse_cabac.py for CABAC)
fills the picture's SoA arrays, then one reconstruction, the same for
both entropy coders:
  - all-inter P picture: the levels, MVs, refs, QP and nnz go to the
    device once; ops/dec.p_dec_residuals (with the 8x8 inverse transform
    of the MBs that use it, which jm_tpu reconstructs on the host),
    ops/dec.inter_recon_p over the
    stacked list0 reference states, ops/deblock.compute_bs + deblock (the
    CUDA kernels K1 / K2 on the card), ops/enc.prep_ref;
  - P picture with intra MBs: the same device inter recon gives the seed
    planes; the host Reconstructor fills in the intra MBs; the planes go
    back to the device for bS, deblock and prep_ref;
  - I picture: the host Reconstructor, then the same device tail;
  - SP picture (spec 8.6.1; jm_tpu reconstructs SP MBs on the host,
    recon.py _sp_luma / _sp_chroma): its inter MBs' prediction from
    the device inter recon without their residual, then ops/dec
    .sp_recon, batched over them, requantizes prediction + levels at QS;
    its intra MBs as in any P picture; compute_bs forces bS 4 / 3 on
    every edge of its MBs;
  - B picture: as a P picture, with ops/dec.inter_recon_b, which predicts
    each block from list 0, list 1 or both over one stack of the
    picture's references (jm_tpu reconstructs B pictures on the host);
    the bS carries list-1 motion. Its reference lists come from
    decoder/b_slice.ref_lists_b and the modification commands, the
    direct prediction from the motion stored with list1[0].
  - weighted prediction (explicit P and B, implicit B): each slice's
    tables (decoder/wp.WPParams) become per-8x8 weights and offsets on
    the host (wp.block_tables), which the device inter recon applies
    (jm_tpu applies them in its host Reconstructor).
  - above 8 bits (bd = the SPS's luma / chroma bit depths): the same
    stages at QP' = QP + QpBdOffset and clips at (1 << bd) - 1, on
    int16 device planes (ops/consts.plane_dtype), the >8-bit deblock
    kernels (jm_tpu reconstructs and deblocks such pictures on the
    host); the host intra recon is the Python walk (the native one is
    8-bit). Lossless MBs (QP'Y 0 under the bypass flag) take the
    transform bypass: on the device for inter MBs, with the intra DPCM
    in the host Reconstructor.
  - field picture (jm_tpu decoder.py:170-233, :777-853, which
    reconstructs fields on the host): a half-height picture through the
    same stages, with the field scan of its levels, the chroma offset of
    its reference fields of the other parity at 4:2:0 (ops/dec
    inter_recon_p's chroma_dy; none at 4:2:2, where the chroma has the
    luma's rows) and the field rules of compute_bs; its list0 comes from
    the reference fields (dpb.field_ref_list_p: frame units by
    FrameNumWrap descending, the parities alternating from the current
    one), which ``_finish_field`` keeps under the sliding window of frame
    units (dpb.field_window); the two fields of a frame are woven into
    one output frame.
The new reference state stays on the device in the DPB; the output
planes are downloaded from the deblocked picture.

A data-partitioned slice is assembled from its partitions A (header
and MB headers), B (intra residual) and C (inter residual) before it is
parsed. A redundant coding (redundant_pic_cnt > 0) is discarded when the
primary coding of its picture was decoded, and decoded as the picture
when the primary is missing. SEI messages are parsed into
``sei_messages`` (decoder/sei.py).

With conceal_mode 1 or 2 (jm_tpu's concealment, decoder/conceal.py) a
corrupt slice is dropped at its parse error, the MBs no slice covered
take a neutral parse state (Intra16x16 DC, no residual or motion), the
picture is reconstructed and deblocked as any other, and then those MBs
are concealed in the host copy of the deblocked planes, which make the
reference state afterwards (so the next pictures predict from the
concealed pixels); a picture none of whose slices survived, and each
missing picture of a frame_num gap (POC interpolated), becomes a copy
of the closest reference (mode 1) or its motion replayed (mode 2),
stored with a neutral motion field and not deblocked again; in every
format the decoder reads, with jm_tpu's 8-bit, 4:2:0 readings of
4:2:2 and >8-bit samples copied (decoder/conceal.py). A field stream
keeps its reference fields out of the DPB of frames, so a lost field
is not concealed, as in jm_tpu. Without
concealment a picture with uncoded MBs raises ValueError, as in jm_tpu.

The decoder runs on CUDA unless the caller passes device="cpu" (then
the deblock is the plain PyTorch wavefront); a CUDA request without a
card raises. A stream outside the scope raises NotImplementedError naming
the construct before the picture that uses it is reconstructed; AUD,
filler and end-of-sequence NAL units are skipped.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.bitreader import BitReader
from ..bitstream.nal import NalUnit, NalUnitType, split_annexb
from ..common.fmo import mb_to_slice_group_map, next_mb_arrays
from ..common.picture import MB_I4, MB_I16, MB_INTER, MB_IPCM, PictureData
from ..common.types import SliceType
from ..convert import qpc_tables
from ..device import resolve
from ..ops import dec as D
from ..ops.deblock import compute_bs, deblock
from ..ops.enc import prep_ref
from .b_slice import ColMotion, compute_mvscale, ref_lists_b
from .conceal import HostRef, closest_ref, conceal_lost_frame, conceal_mbs
from .dpb import DPB, Frame, field_ref_list_p, field_window
from .header import PocContext, parse_slice_header
from .mb_parse import MBParser, SliceContext
from .mb_parse_cabac import MBParserCABAC
from .parset import parse_pps, parse_sps, parse_subset_sps
from .recon import Reconstructor, build_inv_scale, build_inv_scale8
from .sei import parse_sei_rbsp
from .wp import WPParams, block_tables

I32 = torch.int32


@dataclass
class DecodedFrame:
    poc: int
    Y: np.ndarray
    U: np.ndarray
    V: np.ndarray
    view_id: int = 0           # MVC: 0 the base view, 1 the dependent one


_FIELD_UID0 = 1 << 20          # reference fields' uids, apart from the DPB's
_VIEW1_UID0 = 1 << 24          # the view-1 DPB's, apart from view 0's


class H264Decoder:
    """Decoder state (SPS / PPS maps, DPB, POC) persists across
    ``decode_annexb`` calls, so a stream may be fed in pieces.
    ``pictures`` holds one record per decoded picture: slice type, view,
    path ("inter", "mixed", "intra") and the wall seconds of its host parse,
    host intra recon, device stages and the whole picture.
    ``sei_messages`` holds the parsed SEI messages (decoder/sei.py
    SEIMessage) in stream order.

    conceal_mode (jm_tpu's, ldecod ConcealMode): 0 strict, a picture with
    macroblocks that no slice coded raises ValueError and a corrupt slice
    raises; 1 frame copy and 2 motion copy, where a corrupt slice is
    dropped and its MBs and the uncoded ones are concealed after the
    deblock (decoder/conceal.py conceal_mbs), a picture none of whose
    slices survived and each picture of a frame_num gap become a copy of
    the closest reference (mode 1) or its motion replayed (mode 2).
    ``concealed_count`` counts the concealed MBs and whole frames,
    ``conceal_s`` the wall seconds of the concealment.

    ``stats`` (jm_tpu's, after ldecod's dec_statistics.c): the bits
    (8 (RBSP + 1) bytes) and the count of the NAL units by type, the
    decoded pictures and their slices, and the MBs of the frame pictures
    by class (Intra4x4, Intra8x8, Intra16x16, I_PCM, inter, of which
    skipped).

    MVC stereo (Annex H, two views): the subset SPS (NAL 15) serves the
    view-1 slices (NAL 20); view 1 has a DPB and a POC state of its own;
    each view-1 P or B list gets the current access unit's view-0
    picture appended (an anchor's list is that picture alone), which the
    inter-view modification commands (idc 4 / 5) move; prefix NAL units
    (14) are skipped. Concealment and the frame_num gaps stay view 0's,
    as in jm_tpu."""

    def __init__(self, device="cuda", conceal_mode: int = 0) -> None:
        if conceal_mode not in (0, 1, 2):
            raise ValueError(f"conceal_mode={conceal_mode!r}: 0, 1 or 2")
        self.device = resolve(device, "H264Decoder")
        self.conceal_mode = conceal_mode
        self.concealed_count = 0
        self.conceal_s = 0.0
        # the last reference frame's frame_num and the last frame's POC,
        # for the frame_num gaps of concealment
        self._prev_ref_frame_num = None
        self._prev_poc = 0
        self.sps_map: dict = {}
        self.subset_sps_map: dict = {}  # MVC (NAL 15)
        self.pps_map: dict = {}
        self.dpb: DPB | None = None
        self.dpb1: DPB | None = None    # the dependent view's
        self.poc_ctx = PocContext()
        self.poc_ctx1 = PocContext()
        self._last_v0 = None            # view-0 frame of the current AU
        self._cur = None            # the picture being parsed
        self._outputs: list[DecodedFrame] = []
        self._tabs: dict = {}       # id(pps) -> (pps, device tables)
        self.pictures: list[dict] = []
        self.sei_messages: list = []
        self._dp_pending = None     # the partitions of a DP slice so far
        # (frame_num, pic_order_cnt_lsb) of the last primary pictures
        self._primary_keys: list = []
        # PAFF: the reference fields (newest first), the first field of a
        # frame awaiting its second (its Frame and host planes), the next
        # field uid
        self._field_refs: list[Frame] = []
        self._pending_field = None
        self._field_uid = _FIELD_UID0
        self.stats = {
            "nal_bits": {}, "nal_count": {},
            "mb_intra4": 0, "mb_intra16": 0, "mb_intra8": 0, "mb_ipcm": 0,
            "mb_inter": 0, "mb_skip": 0, "slices": 0, "pictures": 0,
        }

    # ------------------------------------------------------------------

    def decode_annexb(self, data: bytes) -> list[DecodedFrame]:
        """Decode an Annex-B chunk; returns the frames completed by this
        call, in decode order."""
        start = len(self._outputs)
        try:
            for nal in split_annexb(data):
                t = int(nal.nal_unit_type)
                nb, nc = self.stats["nal_bits"], self.stats["nal_count"]
                nb[t] = nb.get(t, 0) + 8 * (len(nal.rbsp) + 1)
                nc[t] = nc.get(t, 0) + 1
                self._handle_nal(nal)
            self._flush_dp()
        except EOFError as e:
            raise ValueError(f"truncated NAL unit: {e}") from e
        self._finish_picture()
        return self._outputs[start:]

    def _handle_nal(self, nal: NalUnit) -> None:
        t = nal.nal_unit_type
        if t == NalUnitType.DPA:
            self._flush_dp()
            self._dp_pending = {"a": nal, "b": None, "c": None}
            return
        if t in (NalUnitType.DPB, NalUnitType.DPC):
            # a partition B / C without its partition A is discarded, as
            # ldecod does
            if self._dp_pending is not None:
                self._dp_pending["b" if t == NalUnitType.DPB else "c"] = nal
            return
        self._flush_dp()
        if t == NalUnitType.SPS:
            sps = parse_sps(nal.rbsp)
            self.sps_map[sps.seq_parameter_set_id] = sps
        elif t == NalUnitType.PPS:
            pps = parse_pps(nal.rbsp, self.sps_map)
            self.pps_map[pps.pic_parameter_set_id] = pps
        elif t in (NalUnitType.SLICE, NalUnitType.IDR):
            self._handle_slice(nal)
        elif t == NalUnitType.SEI:
            sps = next(iter(self.sps_map.values()), None)
            self.sei_messages.extend(parse_sei_rbsp(nal.rbsp, sps))
        elif t == NalUnitType.SUBSET_SPS:
            sub = parse_subset_sps(nal.rbsp)
            self.subset_sps_map[sub.seq_parameter_set_id] = sub
        elif t == NalUnitType.SLICE_EXT:
            if nal.mvc_ext is None:
                raise NotImplementedError(
                    "out of scope: SVC slice extensions (NAL unit type 20 "
                    "with svc_extension_flag 1)")
            self._handle_slice(nal)
        # AUD, end of sequence / stream, filler, auxiliary, and the MVC
        # prefix (14) of a base-view slice: skipped

    def _flush_dp(self) -> None:
        """Parse the pending data-partitioned slice: partitions B and C
        open with slice_id (and redundant_pic_cnt when the PPS of
        partition A's header has the flag; ldecod image.c read_new_slice,
        jm_tpu decoder.py _flush_dp)."""
        if self._dp_pending is None:
            return
        dp, self._dp_pending = self._dp_pending, None
        peek = BitReader(dp["a"].rbsp)
        peek.ue()                           # first_mb_in_slice
        peek.ue()                           # slice_type
        pps = self.pps_map.get(peek.ue())
        readers = {}
        for key in ("b", "c"):
            if dp[key] is None:
                continue
            br = BitReader(dp[key].rbsp)
            br.ue()                         # slice_id
            if pps is not None and pps.redundant_pic_cnt_present_flag:
                br.ue()                     # redundant_pic_cnt
            readers[key] = br
        self._handle_slice(dp["a"], dp_readers=readers)

    def _handle_slice(self, nal: NalUnit, dp_readers=None) -> None:
        """Parse one slice into the current picture; dp_readers: the
        readers of partitions B and C when nal is a partition A."""
        t0 = time.perf_counter()
        view = nal.mvc_ext["view_id"] if nal.mvc_ext is not None else 0
        smap = self.sps_map if view == 0 else (self.subset_sps_map
                                               or self.sps_map)
        hdr, br = parse_slice_header(nal, smap, self.pps_map)
        # context, not syntax: no field of SliceHeader, as in jm_tpu
        hdr.view_id = view
        pps = self.pps_map[hdr.pic_parameter_set_id]
        sps = smap[pps.seq_parameter_set_id]
        if view == 0:
            if self.dpb is None:
                self.dpb = DPB(sps)
            dpb = self.dpb
        else:
            if self.dpb1 is None:
                self.dpb1 = DPB(sps, uid0=_VIEW1_UID0)
            dpb = self.dpb1
        if hdr.redundant_pic_cnt > 0:
            # a redundant coding (spec 7.4.3; jm_tpu decoder.py:159-168):
            # discarded when the primary coding of its picture decoded,
            # else decoded as the picture. Checked before _is_new_picture,
            # which would open a new picture on its nal_ref_idc 0.
            self._finish_picture()
            if (hdr.frame_num, hdr.pic_order_cnt_lsb) in self._primary_keys:
                return
        fld = bool(hdr.field_pic_flag)
        if view == 0 and not fld and self._field_refs and not hdr.is_idr:
            # the reference fields are not in the frame DPB, so a frame P
            # picture would predict from a DPB without them (jm_tpu
            # decoder.py:184-191)
            raise NotImplementedError(
                "out of scope: mixed field/frame pictures (adaptive PAFF)")
        if self._is_new_picture(hdr):
            self._finish_picture()
            poc = (self.poc_ctx if view == 0 else self.poc_ctx1).compute(
                hdr, sps)
            if (view == 0 and self.conceal_mode and not hdr.is_idr
                    and self._prev_ref_frame_num is not None
                    and self.dpb.frames):
                self._conceal_frame_num_gap(hdr, sps, poc)
            t0 = time.perf_counter()
            pic = PictureData(sps.pic_width_in_mbs,
                              sps.frame_height_in_mbs // (2 if fld else 1),
                              sps.chroma_format_idc)
            pic.field_mode = fld
            self._cur = {
                "pic": pic, "sps": sps, "pps": pps, "hdr0": hdr,
                "headers": [], "poc": poc, "t0": t0, "parse_s": 0.0,
                "refs": {}, "mb_succ": None, "wps": [], "l0": [],
                "n_slices": 0, "failed": [], "view": view,
                "parity": hdr.bottom_field_flag if fld else None,
            }
            if pps.num_slice_groups_minus1 > 0:
                # FMO: each slice walks its slice group's MBs
                self._cur["mb_succ"] = next_mb_arrays(mb_to_slice_group_map(
                    pps, sps, hdr.slice_group_change_cycle))
        cur = self._cur
        pic = cur["pic"]

        # a view-1 list takes the current access unit's view-0 picture
        # after its temporal references (H.8.2.1; ldecod mbuffer_mvc.c
        # init_lists_p/b_slice_mvc); an anchor's list is that picture
        iv = None
        if view > 0:
            iv = self._last_v0
            if iv is None:
                raise ValueError("view-1 slice without its view-0 picture")
        ivs = [iv] if iv is not None else []
        lst, lst1 = [], []
        nact = hdr.num_ref_idx_l0_active_minus1 + 1
        p_like = hdr.slice_type in (SliceType.P, SliceType.SP)
        if fld and p_like:
            max_fn = sps.max_frame_num
            lst = field_ref_list_p(
                self._field_refs, cur["parity"],
                lambda f: f.frame_num - max_fn
                if f.frame_num > hdr.frame_num else f.frame_num)[:nact]
        elif p_like:
            base = ivs if view > 0 and hdr.is_idr \
                else dpb.ref_list_p(hdr.frame_num) + ivs
            lst = dpb.reorder_list(base, hdr.ref_pic_list_mod_l0,
                                   hdr.frame_num, nact, inter_view=iv)
        elif hdr.slice_type == SliceType.B:
            b0, b1 = ref_lists_b(dpb.frames, cur["poc"])
            lst = dpb.reorder_list(b0 + ivs, hdr.ref_pic_list_mod_l0,
                                   hdr.frame_num, nact, inter_view=iv)
            lst1 = dpb.reorder_list(
                b1 + ivs, hdr.ref_pic_list_mod_l1, hdr.frame_num,
                hdr.num_ref_idx_l1_active_minus1 + 1, inter_view=iv)
            if not lst1:
                raise ValueError("insufficient reference frames")
        if hdr.slice_type != SliceType.I and len(lst) < nact:
            raise ValueError("insufficient reference frames")
        sid = cur["n_slices"]
        cur["n_slices"] += 1
        ctx = SliceContext(hdr, sps, pps, sid, mb_succ=cur["mb_succ"])
        if lst1:
            # direct prediction (jm_tpu decoder.py:266-277)
            col = lst1[0]
            if col.motion is None:
                raise ValueError("colocated picture has no stored motion")
            mv0, r0, mv1, r1, rp0, rp1 = col.motion
            ctx.b_col = ColMotion(mv0, r0, mv1, r1, pic.mb_w,
                                  col.is_long_term, rp0, rp1)
            ctx.b_tdirect = ({f.uid: i for i, f in enumerate(lst)},
                             [f.is_long_term for f in lst],
                             compute_mvscale(cur["poc"], lst, col.poc))
        if pps.entropy_coding_mode_flag:
            if dp_readers is not None:
                raise ValueError("data partitioning is CAVLC-only")
            parser = MBParserCABAC(pic, ctx, br)
        else:
            parser = MBParser(pic, ctx, br)
            if dp_readers is not None:
                br.ue()                     # partition A's slice_id
                parser.dp_mode = True
                parser.br_b = dp_readers.get("b")
                parser.br_c = dp_readers.get("c")
        try:
            parser.parse_slice_data()
        except Exception:
            if not self.conceal_mode:
                raise
            # a corrupt slice is dropped: its MBs are concealed when the
            # picture is finished (jm_tpu decoder.py:289-299)
            cur["failed"].append(sid)
            cur["wps"].append(None)
            cur["parse_s"] += time.perf_counter() - t0
            return
        cur["headers"].append(hdr)
        cur["l0"].append(lst)
        cur["wps"].append(WPParams(hdr, pps, lst, lst1, cur["poc"],
                                   (sps.bit_depth_luma,
                                    sps.bit_depth_chroma)))
        for f in lst + lst1:             # the picture's references by uid
            cur["refs"].setdefault(f.uid, f)

        # per-MB ref uids of each list, for the deblock strengths and the
        # recon's reference stack
        mask = pic.slice_id == sid
        for frames, ridx_arr, pid_arr in ((lst, pic.ref_idx, pic.ref_pic_id),
                                          (lst1, pic.ref_idx_l1,
                                           pic.ref_pic_id_l1)):
            if frames:
                uid = np.array([f.uid for f in frames], np.int64)
                ridx = ridx_arr[mask]
                pid_arr[mask] = np.where(
                    ridx >= 0, uid[np.clip(ridx, 0, len(frames) - 1)], -1)
        cur["parse_s"] += time.perf_counter() - t0

    def _is_new_picture(self, hdr) -> bool:
        """ldecod/src/image.c:2276 is_new_picture."""
        if self._cur is None:
            return True
        h0 = self._cur["hdr0"]
        return (hdr.frame_num != h0.frame_num
                or hdr.field_pic_flag != h0.field_pic_flag
                or hdr.bottom_field_flag != h0.bottom_field_flag
                or hdr.pic_parameter_set_id != h0.pic_parameter_set_id
                or hdr.is_idr != h0.is_idr
                or (hdr.is_idr and hdr.idr_pic_id != h0.idr_pic_id)
                or hdr.pic_order_cnt_lsb != h0.pic_order_cnt_lsb
                or hdr.delta_pic_order_cnt_bottom
                != h0.delta_pic_order_cnt_bottom
                or tuple(hdr.delta_pic_order_cnt)
                != tuple(h0.delta_pic_order_cnt)
                or (hdr.nal_ref_idc == 0) != (h0.nal_ref_idc == 0)
                or hdr.view_id != h0.view_id)

    # ------------------------------------------------------------------

    def _pps_tabs(self, pps, bd):
        """Device tables of a PPS at the SPS's bit depths bd = (luma,
        chroma): inter InvLevelScale lists 3 / 4 / 5 by QP', the QP ->
        QPc maps of its Cb / Cr offsets (convert.qpc_tables: indexed at
        QPY + QpBdOffsetY) and the inter LevelScale8 (list 7)."""
        hit = self._tabs.get((id(pps), bd))
        if hit is None or hit[0] is not pps:
            tab4 = build_inv_scale(pps)
            hit = (pps, tuple(torch.as_tensor(tab4[i], device=self.device)
                              for i in (3, 4, 5))
                   + qpc_tables(pps, self.device, bd)
                   + (torch.as_tensor(build_inv_scale8(pps)[1],
                                      device=self.device),))
            self._tabs[(id(pps), bd)] = hit
        return hit[1]

    def _upload(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint16:          # >8-bit host planes: int16 on
            a = a.view(np.int16)          # the device (consts.plane_dtype)
        return torch.as_tensor(a, device=self.device)

    def _inter_recon(self, pic, refs, tabs, inter, qp, mv, is_b, wps, bd,
                     ll, parity=None):
        """Device residual decode + inter recon of the inter MBs (qp, mv:
        the picture's, on the device). refs: the picture's reference
        frames; each MB's reference is found by uid, so slices with
        different list orders share one stack. is_b: a B picture, whose
        blocks predict from list 0, list 1 or both. wps: each slice's
        WPParams; the weights are indexed by slice, list and ref_idx, not
        by the stack (decoder/wp.block_tables). bd: the (luma, chroma) bit
        depths; ll: the (N,) bool mask of lossless MBs, or None; parity:
        a field picture's (0 top, 1 bottom), whose reference fields of the
        other parity move its chroma vectors, else None."""
        tabY, tabU, tabV, qpc_cb, qpc_cr, tab8 = tabs
        up = self._upload
        t8 = {}
        if pic.transform8x8.any():
            t8 = dict(luma_coef8=up(pic.luma_coef8),
                      transform8x8=up(pic.transform8x8), tab8=tab8)
        res_l, res_c = D.p_dec_residuals(
            up(pic.luma_coef), up(pic.chroma_dc), up(pic.chroma_coef),
            qp, tabY, tabU, tabV, qpc_cb, qpc_cr,
            mb_w=pic.mb_w, mb_h=pic.mb_h, bd=bd,
            lossless=None if ll is None else up(ll), field=pic.field_mode,
            **t8)
        sp = np.flatnonzero(pic.sp_mb)
        if sp.size:
            # the SP MBs' inter recon is their prediction alone; sp_recon
            # then requantizes it with their levels
            keep = up(~pic.sp_mb)
            res_l = res_l * keep[:, None, None, None]
            res_c = res_c * keep[:, None, None, None, None]

        def stack_idx(pid):
            idx = np.full(pid.shape, -1, np.int32)
            for k, f in enumerate(refs):
                idx[pid == f.uid] = k
            return up(idx)

        stacks = tuple(torch.stack([f.state[i] for f in refs])
                       for i in range(3))
        wp = None
        if any(w is not None and w.mode for w in wps):
            wp = tuple(up(t) for t in block_tables(wps, pic))
        if is_b:
            return D.inter_recon_b(
                mv, up(pic.mv_l1), stack_idx(pic.ref_pic_id),
                stack_idx(pic.ref_pic_id_l1), up(pic.pdir), res_l, res_c,
                *stacks, up(inter), mb_w=pic.mb_w, mb_h=pic.mb_h, wp=wp,
                bd=bd)
        chroma_dy = None
        if parity is not None and pic.n_crows == 2:
            # at 4:2:0 only: a 4:2:2 field's chroma has the luma's rows,
            # and its vertical vector is the luma's (spec 8.4.1.4; jm_tpu
            # recon.py:603-612)
            chroma_dy = up(np.array([(-2 if parity == 0 else 2)
                                     if f.parity not in (None, parity)
                                     else 0 for f in refs], np.int32))
        planes = D.inter_recon_p(mv, stack_idx(pic.ref_pic_id), res_l,
                                 res_c, *stacks, up(inter), mb_w=pic.mb_w,
                                 mb_h=pic.mb_h, wp=wp, bd=bd,
                                 chroma_dy=chroma_dy)
        if sp.size:
            planes = D.sp_recon(
                *planes, up(sp.astype(np.int64)), up(pic.luma_coef),
                up(pic.chroma_dc), up(pic.chroma_coef), qp,
                up(pic.sp_qs), up(pic.sp_switch), mb_w=pic.mb_w)
        return planes

    def _reconstruct(self, pic, cur, rec, prep: bool = True):
        """Reconstruct, deblock and (with prep) prep one parsed picture;
        fills the timing record ``rec``. Returns (Y, U, V host planes,
        the device reference state, or without prep None)."""
        pps, sps = cur["pps"], cur["sps"]
        bd = (sps.bit_depth_luma, sps.bit_depth_chroma)
        refs = list(cur["refs"].values())
        tabs = self._pps_tabs(pps, bd)
        inter = pic.mb_class == MB_INTER
        is_b = any(h.slice_type == SliceType.B for h in cur["headers"])
        # lossless MBs (QP'Y 0 under the bypass flag), or None
        ll = None
        if sps.qpprime_y_zero_transform_bypass_flag:
            ll = pic.qp + 6 * sps.bit_depth_luma_minus8 == 0
        up = self._upload
        t = time.perf_counter()
        qp, mv = up(pic.qp), up(pic.mv)
        par = cur["parity"]
        if inter.all():
            rec["path"] = "inter"
            Y, U, V = self._inter_recon(pic, refs, tabs, inter, qp, mv, is_b,
                                        cur["wps"], bd, ll, par)
        else:
            seed = None
            if inter.any():
                rec["path"] = "mixed"
                seed = [p.cpu().numpy() for p in self._inter_recon(
                    pic, refs, tabs, inter, qp, mv, is_b, cur["wps"], bd,
                    ll, par)]
            else:
                rec["path"] = "intra"
            t1 = time.perf_counter()
            rec["device_s"] += t1 - t
            planes = Reconstructor(
                pic, pps, bd,
                bool(sps.qpprime_y_zero_transform_bypass_flag)).run(seed)
            t = time.perf_counter()
            rec["host_recon_s"] = t - t1
            Y, U, V = (up(p) for p in planes)

        n = pic.n_mbs
        t8 = up(pic.transform8x8.astype(np.int32))
        bs_v, bs_h = compute_bs(
            up(pic.mb_class), up(pic.luma_nnz), t8, mv,
            up(pic.mv_l1), up(pic.ref_pic_id), up(pic.ref_pic_id_l1),
            pic.mb_w, pic.mb_h, field=pic.field_mode,
            sp_slice=up(pic.sp_slice) if pic.sp_slice.any() else None)
        disable = np.zeros(n, np.int32)
        a_off = np.zeros(n, np.int32)
        b_off = np.zeros(n, np.int32)
        for sid, hdr in enumerate(cur["headers"]):
            m = pic.slice_id == sid
            disable[m] = hdr.disable_deblocking_filter_idc
            a_off[m] = hdr.slice_alpha_c0_offset_div2
            b_off[m] = hdr.slice_beta_offset_div2
        dY, dU, dV = deblock(
            Y, U, V, bs_v, bs_h, qp, up(disable), up(a_off),
            up(b_off), up(pic.slice_id), t8, tabs[3], tabs[4],
            mb_w=pic.mb_w, mb_h=pic.mb_h, bd=bd)
        state = prep_ref(dY, dU, dV, bd[0]) if prep else None
        flat = torch.cat([dY.reshape(-1), dU.reshape(-1),
                          dV.reshape(-1)]).cpu().numpy()
        if flat.dtype == np.int16:        # >8-bit: uint16 host planes
            flat = flat.view(np.uint16)
        rec["device_s"] += time.perf_counter() - t
        ny, nc = dY.numel(), dU.numel()
        return (flat[:ny].reshape(dY.shape),
                flat[ny:ny + nc].reshape(dU.shape),
                flat[ny + nc:].reshape(dV.shape), state)

    def _finish_picture(self) -> None:
        if self._cur is None:
            return
        cur, self._cur = self._cur, None
        pic, sps = cur["pic"], cur["sps"]
        view = cur["view"]
        dpb = self.dpb if view == 0 else self.dpb1
        if not cur["headers"]:
            # every slice of the picture was corrupt (conceal_mode only):
            # the whole frame is concealed (jm_tpu decoder.py:608-615)
            if self.dpb.frames:
                self._store_concealed(cur["hdr0"].frame_num, cur["poc"],
                                      sps)
            return
        # the first slice that was decoded, as in jm_tpu
        hdr0 = cur["headers"][0]
        lost = pic.slice_id < 0
        for sid in cur["failed"]:
            lost |= pic.slice_id == sid
        if lost.any():
            if not self.conceal_mode:
                raise ValueError("slice data missing for some macroblocks")
            _neutral(pic, lost)
        if cur["parity"] is not None and \
                hdr0.adaptive_ref_pic_marking_mode_flag:
            # field PicNums count fields (spec 8.2.5.4): not covered, as in
            # jm_tpu, which raises once the field is decoded (decoder.py:816)
            raise NotImplementedError("out of scope: field MMCO")
        rec = {"type": hdr0.slice_type.name, "view": view,
               "parse_s": cur["parse_s"],
               "host_recon_s": 0.0, "device_s": 0.0}
        Y, U, V, state = self._reconstruct(pic, cur, rec,
                                           prep=not lost.any())
        if lost.any():
            # the lost MBs concealed in the deblocked host planes, which
            # then make the reference (jm_tpu decoder.py:684-693)
            t = time.perf_counter()
            ref = None
            if hdr0.slice_type != SliceType.I and cur["l0"][0]:
                ref = cur["l0"][0][0]
            elif dpb.frames:
                ref = closest_ref(dpb.frames, cur["poc"])
            self.concealed_count += conceal_mbs(
                Y, U, V, pic, lost, None if ref is None else
                HostRef(ref.state), pic.mb_w, pic.mb_h)
            state = prep_ref(*(self._upload(p) for p in (Y, U, V)),
                             sps.bit_depth_luma)
            rec["conceal_s"] = time.perf_counter() - t
            self.conceal_s += rec["conceal_s"]
        if hdr0.redundant_pic_cnt == 0:
            # later redundant codings of this picture are discarded
            self._primary_keys.append((hdr0.frame_num,
                                       hdr0.pic_order_cnt_lsb))
            del self._primary_keys[:-32]
        motion = (pic.mv, pic.ref_idx, pic.mv_l1, pic.ref_idx_l1,
                  pic.ref_pic_id, pic.ref_pic_id_l1)
        if cur["parity"] is not None:
            self._finish_field(cur, Frame(
                poc=cur["poc"], frame_num=hdr0.frame_num, state=state,
                is_ref=hdr0.nal_ref_idc != 0, motion=motion,
                parity=cur["parity"]), (Y, U, V))
            rec["seconds"] = time.perf_counter() - cur["t0"]
            self.pictures.append(rec)
            self._count(cur)
            return
        frame = Frame(poc=cur["poc"], frame_num=hdr0.frame_num, state=state,
                      is_ref=hdr0.nal_ref_idc != 0, motion=motion)
        dpb.store(frame,
                  mmco_ops=(hdr0.mmco_ops
                            if hdr0.adaptive_ref_pic_marking_mode_flag
                            else None),
                  idr=hdr0.is_idr,
                  long_term_flag=hdr0.long_term_reference_flag)
        if view == 0:
            self._last_v0 = frame
            if hdr0.nal_ref_idc:
                self._prev_ref_frame_num = hdr0.frame_num
            self._prev_poc = cur["poc"]
        self._count(cur, pic)
        self._outputs.append(DecodedFrame(cur["poc"],
                                          *_crop_output(sps, Y, U, V),
                                          view_id=view))
        rec["seconds"] = time.perf_counter() - cur["t0"]
        self.pictures.append(rec)

    def _count(self, cur, pic=None) -> None:
        """``stats`` of a decoded picture, with the MB classes of a frame
        picture pic (jm_tpu decoder.py:727-735)."""
        st = self.stats
        st["pictures"] += 1
        st["slices"] += cur["n_slices"]
        if pic is None:
            return
        cls = pic.mb_class
        i4 = cls == MB_I4          # Intra8x8: the I4 class with the 8x8 flag
        st["mb_intra4"] += int((i4 & ~pic.transform8x8).sum())
        st["mb_intra8"] += int((i4 & pic.transform8x8).sum())
        st["mb_intra16"] += int((cls == MB_I16).sum())
        st["mb_ipcm"] += int((cls == MB_IPCM).sum())
        st["mb_inter"] += int((cls == MB_INTER).sum())
        st["mb_skip"] += int(pic.skip.sum())

    # ---- concealment of lost pictures (jm_tpu decoder.py:569-593) -------

    def _conceal_frame_num_gap(self, hdr, sps, cur_poc: int) -> None:
        """A gap in frame_num (spec 7.4.3; ldecod conceal_lost_frames,
        mbuffer.c:1837): each missing reference frame, up to 16, is
        concealed at a POC interpolated between the last frame's and the
        current picture's, rounded as Python rounds."""
        max_fn = sps.max_frame_num
        prev = self._prev_ref_frame_num
        gap = (hdr.frame_num - prev - 1) % max_fn
        if hdr.frame_num == prev or gap == 0 or gap > 16:
            return
        step = (cur_poc - self._prev_poc) / (gap + 1)
        for k in range(1, gap + 1):
            self._store_concealed((prev + k) % max_fn,
                                  int(round(self._prev_poc + step * k)),
                                  sps)

    def _store_concealed(self, frame_num: int, poc: int, sps) -> None:
        """A frame that never arrived: concealed from the DPB, stored as
        a reference and output (uncropped, as jm_tpu's _store_concealed
        outputs it). A field stream's DPB of frames stays empty, so no
        field is concealed this way, as in jm_tpu."""
        t = time.perf_counter()
        f, planes = conceal_lost_frame(
            self.dpb.frames, frame_num, poc, self.conceal_mode,
            16 * sps.frame_height_in_mbs, 16 * sps.pic_width_in_mbs)
        self.dpb.store(f)
        self.concealed_count += 1
        self._prev_ref_frame_num = frame_num
        self._prev_poc = poc
        self._outputs.append(DecodedFrame(poc, *(_host(p) for p in planes)))
        self.conceal_s += time.perf_counter() - t

    # ---- PAFF field pictures (jm_tpu decoder.py:777-853) ---------------

    def _finish_field(self, cur, field: Frame, planes) -> None:
        """Store a decoded field: a uid of its own; an IDR empties the
        reference fields; a reference field joins them under the sliding
        window of frame units (a complementary pair or an unpaired field
        is one unit; spec 8.2.5.3, max_num_ref_frames units kept). The
        second field of a frame (same frame_num, the other parity) is
        woven with the first into the output frame, of the smaller POC;
        planes: the field's deblocked host (Y, U, V)."""
        field.uid = self._field_uid
        self._field_uid += 1
        if cur["hdr0"].is_idr:
            self._field_refs = []
        if field.is_ref:
            self._field_refs = field_window([field] + self._field_refs,
                                            cur["sps"].max_num_ref_frames)
        pend, self._pending_field = self._pending_field, None
        if pend is None or pend[0].frame_num != field.frame_num \
                or pend[0].parity == field.parity:
            self._pending_field = (field, planes)
            return
        top, bot = (pend, (field, planes)) if pend[0].parity == 0 \
            else ((field, planes), pend)
        woven = []
        for a, b in zip(top[1], bot[1]):
            w = np.empty((2 * a.shape[0], a.shape[1]), a.dtype)
            w[0::2], w[1::2] = a, b
            woven.append(w)
        self._outputs.append(DecodedFrame(
            min(top[0].poc, bot[0].poc), *_crop_output(cur["sps"], *woven),
            view_id=cur["view"]))


def _host(p: torch.Tensor) -> np.ndarray:
    """A device plane on the host: uint8, or uint16 for int16 planes."""
    a = p.cpu().numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _neutral(pic, lost) -> None:
    """The parse state of lost MBs (jm_tpu decoder.py:618-641): Intra16x16
    DC without residual, no motion, slice 0; their samples are concealed
    after the deblock."""
    la = np.flatnonzero(lost)
    pic.mb_class[la] = MB_I16
    pic.i16_mode[la] = 2
    for a in (pic.luma_dc, pic.luma_coef, pic.luma_nnz, pic.chroma_dc,
              pic.chroma_coef, pic.chroma_nnz, pic.cbp, pic.mv):
        a[la] = 0
    pic.transform8x8[la] = False
    pic.skip[la] = False
    pic.ref_idx[la] = -1
    pic.ref_idx_l1[la] = -1
    pic.slice_id[la] = 0


def _crop_output(sps, Y, U, V):
    """Apply the SPS frame cropping of a 4:2:0 or 4:2:2 frame (spec
    7.4.2.1.1: CropUnitX = 2, CropUnitY = SubHeightC (2 at 4:2:0, 1 at
    4:2:2) times 2 - frame_mbs_only_flag)."""
    if not sps.frame_cropping_flag:
        return Y, U, V
    sub_h = 1 if sps.chroma_format_idc == 2 else 2
    unit_y = sub_h * (2 - sps.frame_mbs_only_flag)
    left = 2 * sps.frame_crop_left_offset
    right = 2 * sps.frame_crop_right_offset
    top = unit_y * sps.frame_crop_top_offset
    bot = unit_y * sps.frame_crop_bottom_offset
    H, W = Y.shape
    return (Y[top:H - bot, left:W - right],
            U[top // sub_h:(H - bot) // sub_h, left // 2:(W - right) // 2],
            V[top // sub_h:(H - bot) // sub_h, left // 2:(W - right) // 2])


def decode_file(path: str, device="cuda") -> list[DecodedFrame]:
    with open(path, "rb") as f:
        data = f.read()
    return H264Decoder(device=device).decode_annexb(data)
