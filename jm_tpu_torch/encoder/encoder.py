"""H.264 encoder of the port: IPPP or with B pictures (IbP, a dyadic
pyramid or an explicit GOP string), 4:2:0 or 4:2:2 (High 4:2:2, every
picture coded by the host coders), one or several list-0
references for a P picture (one per list for a B picture), with
the trial-encode RD P path (device_rd) or md_low, or every picture coded
by the serial host coders (pipeline="host"), CAVLC (Baseline, or
Extended with data partitioning) or CABAC (Main), the High profile (the
adaptive 8x8 transform, scaling matrices, explicit quant offsets and
adaptive rounding), one or several slices
per picture (slice_mode 1: MBs per slice, 2: bytes per slice), FMO slice
groups (Baseline), a fixed QP, a P and a B QP of their own (qp_p, qp_b)
or JVT-G012 rate control by picture or by basic unit, POC types 0, 1
and 2, long-term
anchors, MMCO marking, open-GOP I anchors with a recovery point SEI and
CRA marking, redundant pictures, the loop filter on or off, a user-data
SEI and VUI timing, weighted prediction of P pictures (explicit) and of B
pictures (explicit or implicit) (twin of jm_tpu.encoder.Encoder: its
pipelined ``encode_stream`` and its per-frame ``encode_frame``).

Each picture takes the route jm_tpu gives it (``_device_path_ok``,
``_device_i_path_ok``): with pipeline="device" and neither custom quant
nor the 8x8 transform, an RD tier (rdo) or I_PCM, I pictures of one
slice and P pictures without weighted prediction, sub-8x8 partitions,
basic units or simulated lossy decoders and with one active reference
are coded on the device as below; every other picture, and every
picture with pipeline="host", is coded MB by MB by the serial host
coders (encoder/intra_host.py, p_host.py, b_host.py, with the RD tools
of encoder/rdo.py, rdoq.py and errdo.py), deblocked on the device all
the same. With rd_picture_decision each picture after the first is
coded, on its route, at QP, QP - 1 and QP + 1, each coding deblocked,
and the coding of least frame-level J = SSD + lambda_mode(QP) 8 bytes
ships (not under rate control, as in jm_tpu).

The pipe (``encode_stream`` of a CAVLC stream without B pictures, with
one slice per picture, a fixed QP, no intra refresh, the loop filter on,
no long-term anchors, no data partitioning, no weighted prediction, no
trellis and no rd_picture_decision, whatever its POC type):
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

The per-frame path (``encode_frame``, and every frame of a stream outside
the pipe), at the picture's QP:
  - I pictures: i_frame_step on the device on the device route, else
    the serial host intra encoder (encoder/intra_host.py);
  - P pictures on the device route: ops/enc.p_frame_step on the device
    (md_low with sp_shards > 1 dividing mb_h: sharded by MB rows over a
    list of devices, parallel/sp_pipeline.py), the download of its
    fields, the host commit with the serial
    re-encode of the intra MBs and the picture's slice boundaries
    (encoder/p_intra.py);
  - other P pictures: the quadrant integer search table of each active
    reference on the device (ops/enc.full_search_sad_quad; with sub8x8
    the 4x4 tables of full_search_sad_blk4), or with search_mode 1-3 the
    EPZS / UMHex searcher (encoder/me_epzs.py, me_umhex.py), the serial
    host P coder (encoder/p_host.py, jm_tpu's _encode_p_mb; with
    rc_basic_unit and a target a QP per basic unit); with weighted_pred
    first the explicit table of each reference, estimated from the
    source and the reference's deblocked planes (encoder/wp_est.py,
    wp_method / wp_iter_mc), and with wp_mcprec the picture is also
    coded with the offset-only and the default tables, and the coding
    of least frame-level J = SSD + lambda_mode 8 bytes ships (not under
    rate control, as in jm_tpu);
  - B pictures (num_b): the frames between two anchors wait for the later
    anchor, which is coded first; then each B: the 16x16 integer search
    tables against both anchors on the device (ops/enc.full_search_sad16)
    or each list's searcher,
    the serial host B coder (encoder/b_host.py: spatial direct / B_Skip,
    16x16 list 0, list 1 or bi-predicted, Intra16x16), as jm_tpu's
    _encode_b_mb, with weighted_bipred 1 each list's estimated table in
    the slice header, with 2 the implicit weights;
then boundary strengths (both lists' motion) + deblock (per-MB QP and
slice id; skipped with deblock=False) + reference prep on the device,
and the host serializer, one NAL unit per slice (three, partitions A /
B / C, for a P slice with data_partition; B slices only through the
Python writers, as in jm_tpu). After every redundant_period-th P picture
a redundant coding follows: a second encode of the frame at qp +
redundant_qp_off against the same reference (on the device route a
device encode and host commit, else the host P coder) and one slice
with redundant_pic_cnt 1 and nal_ref_idc 0; it is neither deblocked nor
stored.

Custom quant (scaling_matrix, offset_matrix, adaptive_rounding) gives
each host coding an encoder/qmatrix.QuantCtx; the adaptive-rounding
offsets carry from coding to coding, re-codings and redundant codings
included, as in jm_tpu. The encoder codes no Intra8x8: with the 8x8
transform only inter MBs choose it.

The encoder's DPB (``refs``, most recent first) holds the reference
pictures with their device states and motion (the direct prediction of
later B pictures reads list1[0]'s, an EPZS search its temporal
predictors): num_ref short-term pictures, at least two with B pictures
(more for the reference Bs of a pyramid or GOP string), and
with long_term_period one long-term anchor beside them (every
long_term_period-th anchor: the IDR's long_term_reference_flag, MMCO 4
and 6 on a P or open-GOP I picture). List0 of a P picture is the
short-term pictures (by POC distance with ref_reorder, which writes the
matching modification commands), then the long-term one; each P picture
predicts from its first num_ref_active entries, as many as the DPB holds
up to num_ref (the slice header overrides the PPS's num_ref where fewer
are active). A B picture predicts from the nearest references
before and after it, with modification commands where they are not the
heads of the decoder's default lists. poc_mem_mgmt unmarks the
short-term picture of least POC by MMCO 1 when the DPB is full;
mmco_policy "cra" unmarks, in the first P anchor after an open-GOP I,
every short-term picture before that I. The pipe writes no MMCO and no
redundant coding: jm_tpu's pipe finalize has neither, and the port keeps
its bytes.
With slice_mode 2 the picture is re-coded on the host until every slice
NAL unit fits slice_argument bytes (the device encode of a P picture
does not depend on the slices and is downloaded once; the first try of
an I picture is one slice per slice group, so with one group it runs on
the device, and later tries on the host; a B picture is re-coded by the
host B coder). Rate control takes each picture's bits (an IDR's with its
SPS / PPS) and the mean absolute difference of the source and deblocked
luma.

With entropy="cabac" the device path and its decisions are the same;
only the host serializer changes (encoder/syntax_cabac.py, with the
cabac_init_idc of each P or B slice the shortest of the three when
cabac_adapt_init is set, and the cabac_zero_words of clause 7.4.2.10).

With pic_interlace=1 every frame is coded as two field pictures, the
top (even lines) then the bottom one (jm_tpu's "field coding v1",
encoder.py:255-276, :1049-1188: CAVLC 4:2:0 IPPP of one slice, a height
that is a multiple of 32; every other option jm_tpu refuses raises
NotImplementedError): an SPS without frame_mbs_only_flag whose map units
are field MB rows; the top field of an IDR frame an IDR I field, every
other field a P field at qp over the first 2 num_ref reference fields
(frame units by FrameNumWrap descending, the parities alternating from
its own), coded by the host coders with the field scan and the chroma
offset of the reference fields of the other parity, deblocked by the
kernels with the field bS rules, kept under a sliding window of frame
units. qp_p, rd_picture_decision, intra_mb_refresh, the user-data SEI,
ref_reorder and poc_mem_mgmt act nowhere there, as in jm_tpu.

With num_views=2 (MVC stereo, Annex H; jm_tpu encoder.py:1383-1416,
:1604-1706) each access unit is the view-0 picture, coded as with one
view (its VCL NAL units after a prefix NAL unit), then the view-1
picture of the same instant (encode_frame's view1), coded by the host
coders in NAL 20 slices (``_emit_view1``); the IDR's SPS (profile 100)
is followed by a Stereo High subset SPS. There is no pipe with two
views.

The encoder runs on CUDA unless the caller passes device="cpu"; without a
card a CUDA request raises.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.bitwriter import BitWriter
from ..bitstream.nal import NalUnitType, annexb_bytes, mvc_ext_bytes
from ..common.conformance import level_check, minimum_level
from ..common.fmo import mb_to_slice_group_map
from ..common.picture import MB_I4, MB_I16, MB_INTER, MB_IPCM, PictureData
from ..common.tables import chroma_qp
from ..common.types import PPS, SPS, SliceType
from ..convert import qpc_tables
from ..decoder.b_slice import ColMotion, ref_lists_b
from ..decoder.dpb import field_ref_list_p, field_window
from ..device import resolve
from ..ops import enc as E
from ..ops.deblock import compute_bs, deblock
from ..ops.intra import i_frame_step
from ..parallel.sp_pipeline import make_sp_mesh, p_frame_step_sharded
from ..ratectl import BasicUnitRC, RateControl
from .b_host import BPicture, HostRef
from .gop import parse_explicit_hierarchy
from .intra_host import IntraPicture
from .me import QUAD_BLKS
from .me_epzs import EPZSearcher
from .me_umhex import UMHexSearcher, UMHexSmpSearcher
from .p_host import PPicture
from .p_intra import CORE_FIELDS, PictureCommit
from .qmatrix import QuantCtx, default_offsets, to_zigzag4, to_zigzag8
from .errdo import ErrdoState
from .rdo import RDOptions, count_mb_bits, lambda_mode
from .sei_write import (build_sei_rbsp, recovery_point,
                        user_data_unregistered)
from .syntax import (serialize_slice, serialize_slice_dp, write_pps,
                     write_slice_header, write_sps, write_subset_sps)
from .syntax_cabac import serialize_slice_cabac
from .wp_est import (build_wp_params, estimate_explicit, estimate_lms,
                     estimate_mc_iter)


def lambda_me(qp: int) -> int:
    """JM md_low lambda in the SAD domain: sqrt(0.85 * 2^((QP-12)/3))."""
    return max(1, int(round((0.85 * 2.0 ** ((qp - 12) / 3.0)) ** 0.5)))


def lambda_mode4(qp: int) -> int:
    """Penalty unit for non-most-probable intra-4x4 modes (4 lambda_me)."""
    return 4 * lambda_me(qp)


@dataclass
class EncoderConfig:
    """The configurations this encoder covers: jm_tpu's device IPPP set
    (4:2:0; chroma_format 2, High 4:2:2, codes every picture on the host
    coders, as jm_tpu does), with device RD or md_low, CAVLC or CABAC,
    random intra refresh, several slices per picture, FMO slice groups
    (CAVLC only), a fixed QP, a P QP of its own, frame-level or basic-unit
    rate control, POC types 0, 1 and 2, the loop filter on or off, VUI
    timing, a user-data SEI, long-term anchors, list reordering, POC-based
    MMCO, data partitioning and redundant pictures; with num_b, B pictures
    between the anchors (one per interval, a dyadic pyramid or an explicit
    GOP string), open-GOP I anchors with a recovery point SEI and CRA
    marking; explicit weighted prediction of P pictures and explicit or
    implicit weighted bi-prediction; pipeline="host"; the High profile: the
    adaptive 8x8 transform, scaling matrices (the lists in raster order, in
    the SPS, the PPS or both), explicit quant offsets and adaptive rounding;
    SP switching pictures (sp_periodicity, qp_sp, qp_sp2; Extended
    profile); the host coders' motion options: up to 16 list-0 references, P8x8
    sub-partitions, SAD or SATD in the fractional search, the full, UMHex,
    UMHex simple or EPZS search with HME predictors; the RD tiers: rdo 0-4
    (tier 3 with num_decoders / loss_rate_a), the trellis (rdoq with
    rdoq_dc, rdoq_cr, rdoq_dc_cr), I_PCM (enable_ipcm 1 or 2) and
    rd_picture_decision; MVC stereo (num_views 2, view1_qp_offset). Values
    outside it raise ValueError, as do jm_tpu's
    refusals with B pictures (POC types 1 / 2, FMO), FMO in profile 77
    (weighted prediction), 100 (the 8x8 transform, scaling matrices) or 122
    (4:2:2) without data partitioning, and scaling matrices with data
    partitioning (profile 88); redundant pictures with data partitioning or
    with B pictures, and the 8x8 transform with data partitioning, raise
    NotImplementedError naming the field; pic_interlace=1 (field
    pictures) with what jm_tpu's field coder refuses too, and redundant
    pictures or field coding with two views.

    The defaults differ from jm_tpu's in two fields: jm_tpu codes every
    picture on the host by default (pipeline="host") with md_low
    (device_rd=False); the port's default is its device pipeline with
    the trial-encode RD, the main path. EncoderConfig(pipeline="host")
    writes jm_tpu's EncoderConfig() stream, whatever device_rd says."""
    width: int = 176
    height: int = 144
    qp: int = 28                 # I-picture QP (and P without qp_p / RC)
    intra_period: int = 0        # 0: only the first frame is an IDR
    search_range: int = 16       # integer full search +-SR (the device
                                 # P step takes 1..16, the host coders
                                 # 1..32: a wider range raises at the
                                 # first P picture, as in jm_tpu)
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
    qp_p: int | None = None      # P-picture QP (None: qp)
    poc_type: int = 0            # pic_order_cnt_type 0, 1 (a 1-entry
                                 # expected cycle) or 2
    rc_enable: bool = False      # frame-level JVT-G012 rate control
    rc_bitrate: float = 0.0      # its target bits/s
    rc_initial_qp: int = 0       # 0: derived from the bits per pixel
    rc_basic_unit: int = 0       # > 0: MBs per basic unit, the QP moving
                                 # from unit to unit within each P picture
                                 # (lencod BasicUnit; 0: one QP per picture)
    # slices (lencod SliceMode / SliceArgument): 0 one slice per slice
    # group, 1 slice_argument MBs per slice, 2 at most slice_argument
    # bytes per slice NAL unit (the picture re-coded until it fits)
    slice_mode: int = 0
    slice_argument: int = 0
    # FMO slice groups (fmo.c; Baseline only): map type 0 interleaved
    # runs, 1 dispersed, 2 foreground boxes, 3-5 evolving, 6 explicit
    num_slice_groups: int = 1
    slice_group_map_type: int = 0
    sg_run_length: tuple = ()            # type 0 (run_length_minus1 + 1)
    sg_top_left: tuple = ()              # type 2
    sg_bottom_right: tuple = ()          # type 2
    sg_change_direction: int = 0         # types 3-5
    sg_change_rate_minus1: int = 0       # types 3-5
    sg_change_cycle: int = 1             # types 3-5 (written per slice)
    sg_ids: tuple = ()                   # type 6: group of every MB
    deblock: bool = True         # False: the loop filter off in every slice
                                 # (lencod LoopFilterDisable)
    enable_vui: bool = False     # VUI timing info in the SPS
    sei_user_data: bytes | None = None   # user_data_unregistered SEI
                                 # before each IDR's slices
    long_term_period: int = 0    # every Nth picture becomes the long-term
                                 # anchor (IDR flag, P: MMCO 4 + 6)
    ref_reorder: int = 0         # 1: list0 by POC distance, with its
                                 # modification commands (ReferenceReorder)
    poc_mem_mgmt: int = 0        # 1: MMCO 1 unmarks the least-POC short-
                                 # term picture of a full DPB
                                 # (PocMemoryManagement)
    data_partition: int = 0      # 1: P slices as partitions A / B / C
                                 # (PartitionMode; Extended profile)
    sp_periodicity: int = 0      # > 0: every Nth anchor after the first
                                 # that is not intra is an SP switching
                                 # picture (SPPicturePeriodicity; Extended
                                 # profile), coded by the host P coder
    qp_sp: int = 24              # the slice QP of SP pictures (QPSPSlice)
    qp_sp2: int = 24             # their switching QP QS (QPSP2Slice)
    redundant_period: int = 0    # a redundant coding after every Nth P
                                 # picture (RedundantPicture)
    redundant_qp_off: int = 4    # its QP above the primary's (0..51)
    num_b: int = 0               # B pictures between anchors (IbP, IbbP..)
    hierarchical: int = 0        # 1: dyadic B pyramid, the middle B of each
                                 # interval a reference (HierarchicalCoding)
    explicit_gop: str = ""       # ExplicitHierarchyFormat coding order of
                                 # the Bs (encoder/gop.py; over hierarchical)
    qp_b: int | None = None      # B-picture QP (None: qp + 2)
    sei_recovery_point: bool = False     # recovery point SEI before each
                                 # open-GOP I (intra_period with num_b)
    mmco_policy: str = ""        # "cra": the anchor after an open-GOP I
                                 # unmarks the references before it (MMCO 1)
    weighted_pred: int = 0       # 1: explicit weighted prediction of P
                                 # pictures (lencod WeightedPrediction)
    wp_method: int = 0           # its estimate: 0 the DC ratio, 1 LMS
                                 # (wp_lms.c)
    wp_iter_mc: int = 0          # > 0: that many rounds of the motion-
                                 # compensated estimate (WPIterMC)
    wp_mcprec: int = 0           # 1: also code each P picture with the
                                 # offset-only and the default tables, keep
                                 # the least frame J (WPMCPrecision)
    weighted_bipred: int = 0     # B pictures: 0 off, 1 explicit, 2 implicit
    pipeline: str = "device"     # "device": the device route where it
                                 # covers the picture; "host": every
                                 # picture by the serial host coders
                                 # (jm_tpu's default)
    sp_shards: int = 1           # >1: the md_low device P step sharded
                                 # by MB rows over this many devices
                                 # (parallel/sp_pipeline.py), the same
                                 # bytes; where it does not divide mb_h,
                                 # or with device_rd or a range above 16,
                                 # the unsharded step runs
    transform8x8: bool = False   # the adaptive 8x8 transform of inter MBs
                                 # (High profile)
    scaling_matrix: int = 0      # scaling lists: 1 in the SPS, 2 in the
                                 # PPS, 3 both (ScalingMatrixPresentFlag)
    scaling_lists4: tuple = ()   # 6 raster 16-entry lists (flat: ())
    scaling_lists8: tuple = ()   # 2 raster 64-entry lists (intra, inter)
    scaling_present: tuple = ()  # 8 per-list flags 0..3 (ScalingList-
                                 # PresentFlagN; () all)
    offset_matrix: tuple = ()    # (off4 (15, 16), off8 (5, 64)) explicit
                                 # quant offsets (QOffsetMatrixFile)
    adaptive_rounding: bool = False  # JVT-N011 (AdaptiveRounding)
    adapt_rnd_period: int = 16   # its offset-list refresh, in MBs of a slice
    adapt_rnd_w: int = 4         # its weight (AdaptRndWFactor)
    # the host coders' motion options (a P picture with several active
    # references or sub8x8 is coded by the host P coder; search_mode and
    # hme act only where a host coder searches, as in jm_tpu)
    num_ref: int = 1             # list-0 references (NumberReferenceFrames)
    sub8x8: bool = False         # P8x8 sub-partitions 8x4 / 4x8 / 4x4
                                 # (InterSearch8x4 / 4x8 / 4x4)
    subpel_satd: bool = True     # SATD in the fractional search, else SAD
                                 # (MEDistortionHPel / QPel)
    search_mode: int = 0         # -1 / 0 full search, 1 UMHex, 2 UMHex
                                 # simple, 3 EPZS (SearchMode)
    hme: bool = False            # HME pyramid predictors for those
                                 # searchers (HMEEnable)
    # the RD tiers (a picture with rdo, I_PCM or the lossy decoders is
    # coded by the host coders, as in jm_tpu)
    rdo: int = 0                 # RDOptimization: 0 cost-based, 1 md_high,
                                 # 2 md_highfast, 3 md_highloss, 4
                                 # md_high_updated (trial codings by J)
    rdoq: int = 0                # trellis quantization (UseRDOQuant)
    rdoq_dc: int = 0             # ... of the Intra16x16 DC blocks (RDOQ_DC)
    rdoq_cr: int = 0             # ... of chroma AC (RDOQ_CR)
    rdoq_dc_cr: int = 0          # ... of chroma DC (RDOQ_DC_CR)
    enable_ipcm: int = 0         # 1: I_PCM an RD candidate, 2: every MB
                                 # I_PCM (EnableIPCM)
    rd_picture_decision: bool = False  # code each picture after the first
                                 # at QP, QP - 1 and QP + 1 and keep the
                                 # least frame J (RDPictureDecision; not
                                 # under rate control)
    num_decoders: int = 0        # rdo 3's simulated lossy decoders
    loss_rate_a: int = 0         # their picture loss rate, percent
                                 # (NumberOfDecoders / LossRateA)
    chroma_format: int = 1       # 1 4:2:0, 2 4:2:2 (High 4:2:2 profile;
                                 # U / V of (height, width / 2))
    pic_interlace: int = 0       # 1: every frame coded as two field
                                 # pictures, top then bottom (lencod
                                 # PicInterlace = 1; CAVLC 4:2:0 IPPP, one
                                 # slice, height % 32 == 0)
    num_views: int = 1           # 2: MVC stereo (Annex H, Stereo High):
                                 # the base view's NAL units, each VCL one
                                 # after a prefix NAL unit, and the
                                 # dependent view in NAL 20 slices
                                 # (lencod NumberOfViews)
    view1_qp_offset: int = 0     # the dependent view's QP above the base
                                 # picture's (qp for its P pictures)


def _profile(cfg: EncoderConfig) -> int:
    """profile_idc of the stream (jm_tpu encoder.py:277-286): High 4:2:2
    at chroma_format 2, else High with two views (the base SPS), else
    Extended with data partitioning or SP
    pictures (even with the 8x8 transform or CABAC, as jm_tpu writes
    them), else High
    with the 8x8 transform or scaling matrices, else Main with CABAC, B
    pictures or weighted prediction, else Baseline."""
    if cfg.chroma_format == 2:
        return 122
    if cfg.num_views == 2:
        return 100               # the base SPS of a stereo stream, as
                                 # lencod writes it
    if cfg.data_partition or cfg.sp_periodicity > 0:
        return 88
    if cfg.transform8x8 or cfg.scaling_matrix:
        return 100
    if cfg.entropy == "cabac" or cfg.num_b or cfg.weighted_pred \
            or cfg.weighted_bipred:
        return 77
    return 66


def _check_field_config(cfg: EncoderConfig) -> None:
    """pic_interlace (0 or 1), and jm_tpu's field coding refusals
    (encoder.py:255-276, checked there before anything else): a height
    not a multiple of 32, and every option outside CAVLC 4:2:0 IPPP of
    one slice raise NotImplementedError."""
    if cfg.pic_interlace not in (0, 1) or isinstance(cfg.pic_interlace,
                                                     bool):
        raise ValueError(f"EncoderConfig.pic_interlace={cfg.pic_interlace!r}"
                         ": 0 or 1")
    if not cfg.pic_interlace:
        return
    if cfg.height % 32:
        raise NotImplementedError(
            f"EncoderConfig.pic_interlace: field coding needs a height that "
            f"is a multiple of 32 (not {cfg.height})")
    if (cfg.num_b or cfg.entropy != "cavlc" or cfg.chroma_format != 1
            or cfg.data_partition or cfg.slice_mode
            or cfg.num_slice_groups > 1 or cfg.weighted_pred
            or cfg.rc_enable or cfg.transform8x8 or cfg.rdoq
            or cfg.long_term_period or cfg.poc_type or cfg.sp_periodicity
            or cfg.num_views != 1):
        raise NotImplementedError(
            "EncoderConfig.pic_interlace: field coding covers CAVLC 4:2:0 "
            "IPPP of one slice (no B pictures, CABAC, 4:2:2, data "
            "partitioning, slice modes, FMO, weighted prediction, rate "
            "control, 8x8 transform, trellis, long-term anchors, POC "
            "types 1 / 2, SP pictures or MVC stereo)")
    if cfg.redundant_period:
        raise NotImplementedError(
            "EncoderConfig.redundant_period: redundant pictures: IPPP "
            "single-view frame coding only (not with pic_interlace, as in "
            "jm_tpu)")


def _check_config(cfg: EncoderConfig) -> None:
    if cfg.width <= 0 or cfg.height <= 0 or cfg.width % 16 \
            or cfg.height % 16:
        raise ValueError(f"EncoderConfig.width/height {cfg.width}x"
                         f"{cfg.height}: positive multiples of 16 only")
    if cfg.num_views not in (1, 2) or isinstance(cfg.num_views, bool):
        raise ValueError(f"EncoderConfig.num_views={cfg.num_views!r}: 1 or "
                         "2")
    if not isinstance(cfg.view1_qp_offset, int) \
            or isinstance(cfg.view1_qp_offset, bool):
        raise ValueError(f"EncoderConfig.view1_qp_offset="
                         f"{cfg.view1_qp_offset!r}: an integer")
    _check_field_config(cfg)
    for name in ("device_rd", "cabac_adapt_init", "rc_enable", "deblock",
                 "enable_vui", "transform8x8", "adaptive_rounding", "sub8x8",
                 "subpel_satd", "hme", "rd_picture_decision"):
        if not isinstance(getattr(cfg, name), bool):
            raise ValueError(f"EncoderConfig.{name}="
                             f"{getattr(cfg, name)!r}: True or False")
    if cfg.entropy not in ("cavlc", "cabac"):
        raise ValueError(f"EncoderConfig.entropy={cfg.entropy!r}: "
                         "'cavlc' or 'cabac'")
    if cfg.chroma_format not in (1, 2) or isinstance(cfg.chroma_format,
                                                     bool):
        raise ValueError(f"EncoderConfig.chroma_format={cfg.chroma_format!r}"
                         ": 1 (4:2:0) or 2 (4:2:2)")
    if cfg.intra_mb_refresh < 0:
        raise ValueError(f"EncoderConfig.intra_mb_refresh="
                         f"{cfg.intra_mb_refresh}: must be >= 0")
    if not 0 <= cfg.qp <= 51:
        raise ValueError(f"EncoderConfig.qp={cfg.qp}: outside 0..51")
    if cfg.qp_p is not None and not 0 <= cfg.qp_p <= 51:
        raise ValueError(f"EncoderConfig.qp_p={cfg.qp_p}: outside 0..51")
    if cfg.sp_periodicity < 0:
        raise ValueError(f"EncoderConfig.sp_periodicity="
                         f"{cfg.sp_periodicity}: must be >= 0")
    for name in ("qp_sp", "qp_sp2"):
        if not 0 <= getattr(cfg, name) <= 51:
            raise ValueError(f"EncoderConfig.{name}={getattr(cfg, name)}: "
                             "outside 0..51")
    if cfg.intra_period < 0:
        raise ValueError(f"EncoderConfig.intra_period={cfg.intra_period}: "
                         "must be >= 0")
    # a range above 16 raises at the first P picture of the device route
    # (ops/enc.band_geometry), above 32 at the host coders' first full
    # search (ops/enc.full_search_sad_quad), as in jm_tpu
    if cfg.search_range <= 0:
        raise ValueError(f"EncoderConfig.search_range={cfg.search_range}: "
                         "must be > 0")
    if cfg.poc_type not in (0, 1, 2):
        raise ValueError(f"EncoderConfig.poc_type={cfg.poc_type}: 0, 1 or 2")
    if cfg.rc_enable and not cfg.rc_bitrate > 0:
        raise ValueError(f"EncoderConfig.rc_bitrate={cfg.rc_bitrate}: "
                         "must be > 0 with rc_enable")
    if not 0 <= cfg.rc_initial_qp <= 51:
        raise ValueError(f"EncoderConfig.rc_initial_qp={cfg.rc_initial_qp}:"
                         " outside 0..51")
    for name, lo, hi in (("rc_basic_unit", 0, None), ("num_ref", 1, 16),
                         ("search_mode", -1, 3), ("rdo", 0, 4),
                         ("rdoq", 0, 1), ("rdoq_dc", 0, 1),
                         ("rdoq_cr", 0, 1), ("rdoq_dc_cr", 0, 1),
                         ("enable_ipcm", 0, 2), ("num_decoders", 0, None),
                         ("loss_rate_a", 0, 100)):
        v = getattr(cfg, name)
        if not isinstance(v, int) or isinstance(v, bool) or v < lo or (
                hi is not None and v > hi):
            raise ValueError(f"EncoderConfig.{name}={v!r}: an integer "
                             f"{lo}..{hi if hi is not None else ''}")
    if cfg.slice_mode not in (0, 1, 2):
        raise ValueError(f"EncoderConfig.slice_mode={cfg.slice_mode}: "
                         "0, 1 or 2")
    if cfg.slice_argument < 0:
        raise ValueError(f"EncoderConfig.slice_argument="
                         f"{cfg.slice_argument}: must be >= 0")
    if not 1 <= cfg.num_slice_groups <= 8:
        raise ValueError(f"EncoderConfig.num_slice_groups="
                         f"{cfg.num_slice_groups}: 1..8")
    if cfg.num_slice_groups > 1:
        if cfg.entropy != "cavlc":
            raise ValueError("EncoderConfig.num_slice_groups: FMO is not "
                             "allowed in profile 77 (Baseline only)")
        if cfg.slice_group_map_type not in range(7):
            raise ValueError(f"EncoderConfig.slice_group_map_type="
                             f"{cfg.slice_group_map_type}: 0..6")
        n = (cfg.width // 16) * (cfg.height // 16)
        t, k = cfg.slice_group_map_type, cfg.num_slice_groups
        if t == 0 and cfg.sg_run_length and len(cfg.sg_run_length) != k:
            raise ValueError("EncoderConfig.sg_run_length: one run per "
                             "slice group")
        if t == 2 and not len(cfg.sg_top_left) == len(
                cfg.sg_bottom_right) == k - 1:
            raise ValueError("EncoderConfig.sg_top_left / sg_bottom_right:"
                             " one box per slice group but the last")
        if t == 6 and len(cfg.sg_ids) != n:
            raise ValueError("EncoderConfig.sg_ids: one slice group id per "
                             "MB")
    if cfg.sei_user_data is not None and not isinstance(cfg.sei_user_data,
                                                        bytes):
        raise ValueError("EncoderConfig.sei_user_data: bytes or None")
    for name in ("long_term_period", "redundant_period"):
        if getattr(cfg, name) < 0:
            raise ValueError(f"EncoderConfig.{name}={getattr(cfg, name)}: "
                             "must be >= 0")
    for name in ("ref_reorder", "poc_mem_mgmt", "data_partition"):
        if getattr(cfg, name) not in (0, 1):
            raise ValueError(f"EncoderConfig.{name}={getattr(cfg, name)}: "
                             "0 or 1")
    if not 0 <= cfg.redundant_qp_off <= 51:
        raise ValueError(f"EncoderConfig.redundant_qp_off="
                         f"{cfg.redundant_qp_off}: outside 0..51")
    if cfg.redundant_period and cfg.data_partition:
        raise NotImplementedError(
            "redundant pictures: IPPP single-view frame coding only "
            "(not with data partitioning, as in jm_tpu)")
    if cfg.redundant_period and cfg.num_views != 1:
        raise NotImplementedError(
            "EncoderConfig.redundant_period: redundant pictures: IPPP "
            "single-view frame coding only (not with num_views=2, as in "
            "jm_tpu)")
    if cfg.pipeline not in ("host", "device"):
        raise ValueError(f"EncoderConfig.pipeline={cfg.pipeline!r}: 'host' "
                         "or 'device'")
    _check_wp_config(cfg)
    _check_b_config(cfg)
    _check_quant_config(cfg)


def _check_quant_config(cfg: EncoderConfig) -> None:
    """The custom-quant fields, and jm_tpu's refusals of scaling matrices
    outside the High profile and of FMO in it."""
    if cfg.scaling_matrix not in (0, 1, 2, 3) \
            or isinstance(cfg.scaling_matrix, bool):
        raise ValueError(f"EncoderConfig.scaling_matrix="
                         f"{cfg.scaling_matrix!r}: 0, 1, 2 or 3")
    for name, n, size in (("scaling_lists4", 6, 16),
                          ("scaling_lists8", 2, 64)):
        lists = getattr(cfg, name)
        if lists and (len(lists) != n or any(
                len(x) != size or not all(1 <= int(v) <= 255 for v in x)
                for x in lists)):
            raise ValueError(f"EncoderConfig.{name}: () or {n} lists of "
                             f"{size} values in 1..255")
    if len(cfg.scaling_present) > 8 or not all(
            p in (0, 1, 2, 3) for p in cfg.scaling_present):
        raise ValueError("EncoderConfig.scaling_present: at most 8 flags "
                         "0..3")
    if cfg.offset_matrix and (
            len(cfg.offset_matrix) != 2
            or np.shape(cfg.offset_matrix[0]) != (15, 16)
            or np.shape(cfg.offset_matrix[1]) != (5, 64)):
        raise ValueError("EncoderConfig.offset_matrix: () or (off4 (15, 16),"
                         " off8 (5, 64))")
    for name in ("adapt_rnd_period", "adapt_rnd_w"):
        v = getattr(cfg, name)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"EncoderConfig.{name}={v!r}: an integer >= 0")
    if cfg.scaling_matrix and _profile(cfg) not in (100, 122):
        raise ValueError("EncoderConfig.scaling_matrix: scaling matrices "
                         "need a High profile (not with data_partition)")
    if cfg.transform8x8 and cfg.data_partition:
        # jm_tpu writes the 8x8 residual of a partitioned slice into
        # partition A, where its own decoder (and the spec) reads it from
        # partition C: a reference fault the port does not copy
        raise NotImplementedError(
            "EncoderConfig.transform8x8 with data_partition: the 8x8 "
            "transform in partitioned slices is not covered")
    if cfg.num_slice_groups > 1 and _profile(cfg) in (100, 122):
        raise ValueError("EncoderConfig.num_slice_groups: FMO is not "
                         f"allowed in profile {_profile(cfg)} (the 8x8 "
                         "transform, scaling matrices, 4:2:2)")


def _check_wp_config(cfg: EncoderConfig) -> None:
    """The weighted prediction fields, and jm_tpu's refusal of FMO in
    profile 77 (weighted prediction makes a CAVLC stream Main unless data
    partitioning makes it Extended)."""
    for name, values in (("weighted_pred", (0, 1)), ("wp_method", (0, 1)),
                         ("wp_mcprec", (0, 1)),
                         ("weighted_bipred", (0, 1, 2))):
        if getattr(cfg, name) not in values or \
                isinstance(getattr(cfg, name), bool):
            raise ValueError(f"EncoderConfig.{name}={getattr(cfg, name)!r}:"
                             f" one of {values}")
    if not isinstance(cfg.wp_iter_mc, int) or cfg.wp_iter_mc < 0 \
            or isinstance(cfg.wp_iter_mc, bool):
        raise ValueError(f"EncoderConfig.wp_iter_mc={cfg.wp_iter_mc!r}: an "
                         "integer >= 0")
    if (cfg.weighted_pred or cfg.weighted_bipred) and \
            cfg.num_slice_groups > 1 and not cfg.data_partition:
        raise ValueError("EncoderConfig.num_slice_groups: FMO is not "
                         "allowed in profile 77 (weighted prediction)")


def _check_b_config(cfg: EncoderConfig) -> None:
    """The B-picture fields, and jm_tpu's refusals with B pictures
    (jm_tpu/encoder/encoder.py:297-331, :367)."""
    for name in ("num_b",):
        if not isinstance(getattr(cfg, name), int) or getattr(cfg, name) < 0:
            raise ValueError(f"EncoderConfig.{name}={getattr(cfg, name)!r}:"
                             " an integer >= 0")
    if cfg.hierarchical not in (0, 1):
        raise ValueError(f"EncoderConfig.hierarchical={cfg.hierarchical}: "
                         "0 or 1")
    if not isinstance(cfg.explicit_gop, str):
        raise ValueError("EncoderConfig.explicit_gop: a string")
    if cfg.qp_b is not None and not 0 <= cfg.qp_b <= 51:
        raise ValueError(f"EncoderConfig.qp_b={cfg.qp_b}: outside 0..51")
    if not isinstance(cfg.sei_recovery_point, bool):
        raise ValueError(f"EncoderConfig.sei_recovery_point="
                         f"{cfg.sei_recovery_point!r}: True or False")
    if cfg.mmco_policy not in ("", "cra"):
        raise ValueError(f"EncoderConfig.mmco_policy={cfg.mmco_policy!r}: "
                         "'' or 'cra'")
    if not cfg.num_b:
        return
    if cfg.explicit_gop:
        # lencod refuses a GOP string that does not name every B position
        # once (explicit_gop.c interpret_gop_structure)
        positions = sorted(e.display_no for e in
                           parse_explicit_hierarchy(cfg.explicit_gop))
        if positions != list(range(cfg.num_b)):
            raise ValueError(
                f"EncoderConfig.explicit_gop names positions {positions}, "
                f"expected exactly 0..{cfg.num_b - 1} (num_b={cfg.num_b})")
    if cfg.poc_type:
        raise ValueError(f"EncoderConfig.poc_type={cfg.poc_type}: POC types "
                         "1 / 2 require decode order == display order (no B "
                         "pictures)")
    if cfg.num_slice_groups > 1:
        raise ValueError("EncoderConfig.num_slice_groups: FMO is not allowed "
                         "in profile 77 (B pictures)")
    if cfg.redundant_period:
        raise NotImplementedError(
            "EncoderConfig.redundant_period: redundant pictures: IPPP "
            "single-view frame coding only (not with B pictures, as in "
            "jm_tpu)")


class Picture:
    """A coded picture: its reference state on the device (``state``,
    ops/enc.prep_ref of the deblocked recon), its marking in the
    encoder's DPB (uid, is_long_term, long_term_frame_idx; a non-reference
    B picture has uid -1) and its motion. Y / U / V are numpy uint8
    planes, downloaded from the state on first access (P and B frames) or
    given (I frames)."""

    def __init__(self, poc: int, frame_num: int, state, uid: int,
                 planes=None):
        self.poc = poc
        self.frame_num = frame_num
        self.state = state
        self.uid = uid
        self.is_long_term = False
        self.long_term_frame_idx = -1
        self.parity = None            # a field's (0 top, 1 bottom)
        self._planes = planes
        # (mv, ref_idx, mv_l1, ref_idx_l1, ref_pic_id, ref_pic_id_l1) of
        # the coded picture, for the direct prediction of the B pictures
        # that take it as list1[0]
        self.motion = None
        self._host_ref = None

    def host_ref(self) -> HostRef:
        """The reference state downloaded for the host B coder (once)."""
        if self._host_ref is None:
            self._host_ref = HostRef(*(t.cpu().numpy() for t in self.state),
                                     self.uid, self.parity)
        return self._host_ref

    @property
    def luma_planes(self):
        """The quarter-pel luma planes of the reference state, downloaded
        (the searchers' reference, encoder/me_epzs.py)."""
        return self.host_ref().planes

    def _materialize(self):
        if self._planes is None:
            p = E.PAD
            planes, padU, padV = self.state
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
    """IPPP / IBP encoder: ``encode_stream(frames)`` returns one Annex-B
    payload per frame, as ``encode_frame(Y, U, V)`` does frame by frame
    (with B pictures b"" for a frame held back, and ``flush()`` the
    frames still held at the end).
    ``results`` holds one dict per coded picture (disp, type, bits, qp,
    slices, frame: a Picture with the deblocked recon; intra_mbs: the MBs
    coded intra and ref_poc: the POC of the reference, for P frames of
    the per-frame path; sp: True for an SP picture (type "P", as jm_tpu
    records it); cabac_init_idc: the context model of each CABAC
    P or B slice; for B pictures ref: whether it is a reference, split:
    the wall seconds of its device search tables, host MB loop, device
    deblock + prep_ref and host serializer, mix: its MB decisions; for
    I pictures mb_classes: the MBs coded Intra4x4, Intra16x16 and I_PCM;
    with rd_picture_decision, for each picture after the first, trials:
    each coding's QP, bytes, frame J and wall ms, the QP shipped being
    ``qp``; with pic_interlace one dict per field picture, with its
    parity, and for P fields mix and mb_parts; with two views a view-0
    picture's bits include its access unit's view-1 bytes, as jm_tpu
    counts them). ``refs`` is the DPB, most recent first (with
    pic_interlace the reference fields). With two views ``results_v1``
    holds one dict per view-1 picture (disp, type, anchor, bits, qp, ref,
    frame, seconds) and ``refs_v1`` view 1's references. ``sp_steps``
    counts the device P steps taken sharded by MB rows (sp_shards) over
    ``_sp_mesh``, a list of torch.devices (parallel/sp_pipeline.py;
    set by parallel/gop_pipeline.py, or made at the first such step)."""

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        _check_config(cfg)
        self.cfg = cfg
        self.device = resolve(device, "Encoder")
        self.mb_w = cfg.width // 16
        # with pic_interlace every coded picture is a field: the SPS's map
        # units, the level and the slice plan count field MB rows
        self.mb_h = cfg.height // (32 if cfg.pic_interlace else 16)
        n_refs = max(cfg.num_ref, 2 if cfg.num_b else 1)
        try:
            level_check(self.mb_w, self.mb_h, cfg.frame_rate, cfg.level_idc,
                        n_refs)
            level = cfg.level_idc
        except ValueError:
            level = minimum_level(self.mb_w, self.mb_h, cfg.frame_rate,
                                  n_refs)
        cabac = cfg.entropy == "cabac"
        # the DPB (jm_tpu encoder.py:285-296): num_ref short-term
        # references, and the long-term anchor; with B pictures at least
        # both anchors, and one reference B per pyramid level or per
        # reference B of the GOP string
        self.dpb_size = max(cfg.num_ref, 2) if cfg.num_b else cfg.num_ref
        if cfg.num_b and cfg.hierarchical:
            levels = max(1, math.ceil(math.log2(cfg.num_b + 1)))
            self.dpb_size = max(self.dpb_size, levels + 2)
        if cfg.num_b and cfg.explicit_gop:
            self.dpb_size = max(self.dpb_size, 2 + sum(
                e.as_ref for e in parse_explicit_hierarchy(cfg.explicit_gop)))
        if cfg.long_term_period > 0:
            self.dpb_size = min(16, self.dpb_size + 1)
        self.sps = SPS(
            profile_idc=_profile(cfg),
            level_idc=level,
            log2_max_frame_num_minus4=4,
            pic_order_cnt_type=cfg.poc_type,
            delta_pic_order_always_zero_flag=1 if cfg.poc_type == 1 else 0,
            offset_for_ref_frame=[2] if cfg.poc_type == 1 else [],
            log2_max_pic_order_cnt_lsb_minus4=4,
            max_num_ref_frames=self.dpb_size,
            pic_width_in_mbs_minus1=self.mb_w - 1,
            pic_height_in_map_units_minus1=self.mb_h - 1,
            chroma_format_idc=cfg.chroma_format,
            frame_mbs_only_flag=0 if cfg.pic_interlace else 1,
            direct_8x8_inference_flag=1)
        if cfg.enable_vui:
            # timing info (lencod GenerateVUI_parameters_rbsp:1048): the
            # frame rate as time_scale / (2 num_units_in_tick)
            self.sps.vui_parameters_present_flag = 1
            self.sps.vui = {"num_units_in_tick": 1000,
                            "time_scale": int(round(cfg.frame_rate * 2000)),
                            "fixed_frame_rate": 1, "pic_struct_present": 0}
        self.pps = PPS(num_ref_idx_l0_default_active_minus1=cfg.num_ref - 1,
                       entropy_coding_mode_flag=1 if cabac else 0,
                       transform_8x8_mode_flag=int(cfg.transform8x8),
                       weighted_pred_flag=cfg.weighted_pred,
                       weighted_bipred_idc=cfg.weighted_bipred,
                       redundant_pic_cnt_present_flag=
                       1 if cfg.redundant_period else 0,
                       deblocking_filter_control_present_flag=
                       0 if cfg.deblock else 1)
        self._init_quant()
        # FMO slice groups (lencod/src/fmo.c FmoInit)
        self.group_map = None
        if cfg.num_slice_groups > 1:
            p = self.pps
            p.num_slice_groups_minus1 = cfg.num_slice_groups - 1
            t = p.slice_group_map_type = cfg.slice_group_map_type
            if t == 0:
                runs = cfg.sg_run_length or (1,) * cfg.num_slice_groups
                p.run_length_minus1 = [r - 1 for r in runs]
            elif t == 2:
                p.top_left = list(cfg.sg_top_left)
                p.bottom_right = list(cfg.sg_bottom_right)
            elif t in (3, 4, 5):
                p.slice_group_change_direction_flag = cfg.sg_change_direction
                p.slice_group_change_rate_minus1 = cfg.sg_change_rate_minus1
            elif t == 6:
                p.slice_group_id = list(cfg.sg_ids)
            self.group_map = mb_to_slice_group_map(p, self.sps,
                                                   cfg.sg_change_cycle)
        self.slice_plan = self._build_slice_plan()
        self.rc = None
        if cfg.rc_enable:
            self.rc = RateControl(cfg.rc_bitrate, cfg.frame_rate, cfg.width,
                                  cfg.height, num_b=cfg.num_b,
                                  initial_qp=cfg.rc_initial_qp)
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
        self.refs = []                # the DPB: references, most recent
                                      # first
        self._uid = 0
        self.results = []
        # display indices of the P frames finished on the per-frame path
        # after the pipe's intra speculation failed, and the dispatches
        # repeated against the corrected reference; display indices of
        # the P frames serialized on the host because the packer
        # overflowed
        self.fallbacks = []
        self.redispatches = 0
        self.sp_steps = 0         # device P steps taken MB-row sharded
        self._sp_mesh = None      # their devices (parallel/sp_pipeline)
        self.ovf = []
        # random intra refresh (intrarefresh.c RandomIntraInit): a seeded
        # permutation of MB addresses taken intra_mb_refresh at a time
        self._refresh_perm = []
        self._refresh_pos = 0
        self._refresh_rng = np.random.default_rng(1)
        self._pending = []            # (disp, frame) of the Bs held back
        # MVC stereo: the view-1 sources by display index, view 1's
        # references (most recent first), view 1's picture of each view-0
        # reference by its uid (a view-1 B predicts from the companions
        # of its view-0 anchors), and one record per view-1 picture
        self._v1_pending: dict = {}
        self.refs_v1: list = []
        self._v1_of: dict = {}
        self.results_v1: list = []
        self._cra_poc = None          # POC of the last open-GOP I
        self.num_ref_active = 1       # list0 entries of the P picture coded
        # rdo 3's simulated lossy decoders, advanced once per anchor
        self.errdo = ErrdoState(cfg.num_decoders, cfg.loss_rate_a,
                                cfg.height, cfg.width) \
            if cfg.num_decoders > 0 and cfg.loss_rate_a > 0 else None
        self.rd = RDOptions(
            rdo=cfg.rdo, rdoq=cfg.rdoq, rdoq_dc=cfg.rdoq_dc,
            rdoq_cr=cfg.rdoq_cr, rdoq_dc_cr=cfg.rdoq_dc_cr,
            enable_ipcm=cfg.enable_ipcm, cabac=cabac, sps=self.sps,
            pps=self.pps, errdo=self.errdo)

    def _init_quant(self) -> None:
        """Custom quant (jm_tpu encoder.py:374-425): the raster scaling
        lists of the QuantCtx (flat without a matrix), the offset lists
        that adaptive rounding carries (``_ar_state``), and the lists
        the SPS and PPS transmit: each list in the sets its
        scaling_present flag names, or in every set of scaling_matrix
        when the flag names none of them, as jm_tpu does (a list sent in
        the SPS only takes the PPS's fall-back in a decoder, while the
        quant uses the configured list: jm_tpu's fault, copied)."""
        cfg = self.cfg
        self.quant_custom = bool(cfg.scaling_matrix or cfg.offset_matrix
                                 or cfg.adaptive_rounding)
        self.qm_lists4 = [list(x) for x in cfg.scaling_lists4] or \
            [[16] * 16 for _ in range(6)]
        self.qm_lists8 = [list(x) for x in cfg.scaling_lists8] or \
            [[16] * 64 for _ in range(2)]
        self._ar_state = None
        self.sps_scaling = self.pps_scaling = None
        if not self.quant_custom:
            return
        if cfg.offset_matrix:
            self._ar_state = tuple(np.array(m, np.int32)
                                   for m in cfg.offset_matrix)
        else:
            self._ar_state = default_offsets()
        sm = cfg.scaling_matrix
        if not sm:
            return
        pres = list(cfg.scaling_present) or [3] * 8
        pres = [(p & sm) or sm for p in pres + [0] * (8 - len(pres))]
        n8 = 2 if cfg.transform8x8 else 0
        zz4 = [to_zigzag4(x) for x in self.qm_lists4]
        zz8 = [to_zigzag8(x) for x in self.qm_lists8]
        lists = zz4 + zz8[:n8]
        if sm & 1:
            self.sps.seq_scaling_matrix_present_flag = 1
            self.sps.scaling_list_4x4 = [list(x) for x in zz4]
            self.sps.scaling_list_8x8 = [list(x) for x in zz8] \
                + [[16] * 64] * 4
            self.sps_scaling = ([p & 1 for p in pres[:6 + n8]], lists)
        if sm & 2:
            self.pps.pic_scaling_matrix_present_flag = 1
            self.pps_scaling = ([(p >> 1) & 1 for p in pres[:6 + n8]],
                                lists)
        self.pps.scaling_list_4x4 = [list(x) for x in zz4]
        self.pps.scaling_list_8x8 = [list(x) for x in zz8] + [[16] * 64] * 4

    def _qctx(self, kind: str):
        """The custom quant of one coding of a picture of slice type kind
        ("I", "P", "B"), over the carried offsets (jm_tpu _FrameEncoder
        :1913-1921); None without custom quant."""
        if not self.quant_custom:
            return None
        cfg = self.cfg
        return QuantCtx(self.qm_lists4, self.qm_lists8, kind,
                        off_state=self._ar_state,
                        ar_weight=cfg.adapt_rnd_w if cfg.adaptive_rounding
                        else 0)

    def _quant_kw(self, kind: str) -> dict:
        """The host coders' quant and RD keywords for a coding of slice
        type kind."""
        return dict(qctx=self._qctx(kind),
                    ar_period=self.cfg.adapt_rnd_period, rd=self.rd)

    def _device_path_ok(self, weighted: bool = False,
                        basic_units: bool = False) -> bool:
        """Whether a P picture is coded on the device (jm_tpu
        _FrameEncoder._device_path_ok, encoder.py:2070): the device
        pipeline, flat quant, no weighted prediction (weighted: its table
        is in use), the 4x4 transform, one active reference, no sub-8x8
        partitions, no basic units of rate control (basic_units: the
        picture has them), no RD tier, no I_PCM and no simulated lossy
        decoders, at 4:2:0, no field coding. search_mode, hme and rdoq are
        no terms, as in
        jm_tpu: the device route searches its own way, and with rdoq only
        the host re-encode of its intra MBs takes the trellis (in
        CAVLC)."""
        cfg = self.cfg
        return (cfg.pipeline == "device" and not self.quant_custom
                and cfg.chroma_format == 1 and not cfg.pic_interlace
                and not weighted and not cfg.transform8x8
                and self.num_ref_active == 1 and not cfg.sub8x8
                and not basic_units and not cfg.rdo
                and cfg.enable_ipcm == 0 and self.errdo is None)

    def _device_i_path_ok(self, plan) -> bool:
        """Whether an I picture is coded on the device (jm_tpu
        _device_i_path_ok, encoder.py:2091): the device pipeline, flat
        quant, one slice in plan, the 4x4 transform, no RD tier, no I_PCM,
        at 4:2:0, no field coding (rdoq is no term: the device I picture
        has no trellis)."""
        cfg = self.cfg
        return (cfg.pipeline == "device" and not self.quant_custom
                and cfg.chroma_format == 1 and not cfg.pic_interlace
                and len(plan) == 1 and not cfg.transform8x8
                and not cfg.rdo and cfg.enable_ipcm == 0)

    def _build_slice_plan(self) -> list:
        """Decode-order MB address lists, one per slice: the slice groups
        in group order (each in raster order), with slice_mode 1 cut into
        slices of slice_argument MBs (jm_tpu _build_slice_plan)."""
        cfg = self.cfg
        n = self.mb_w * self.mb_h
        if self.group_map is None:
            groups = [list(range(n))]
        else:
            groups = [[int(a) for a in np.flatnonzero(self.group_map == g)]
                      for g in range(cfg.num_slice_groups)]
        slices = []
        for addrs in groups:
            if not addrs:
                continue
            if cfg.slice_mode == 1 and cfg.slice_argument > 0:
                k = cfg.slice_argument
                slices.extend(addrs[i:i + k] for i in range(0, len(addrs), k))
            else:
                slices.append(addrs)
        return slices

    def _pipe_ok(self) -> bool:
        """The pipe covers the device route's P pictures (the device
        pipeline, flat quant, no weighted prediction, the 4x4 transform,
        no sub-8x8 partitions, 4:2:0) with one reference (num_ref 1),
        in CAVLC without B pictures, with one slice group and no slice
        mode, a fixed QP, no intra refresh, the loop filter on, no
        long-term anchors, no data partitioning, no SP pictures, no
        trellis, no rd_picture_decision and one view, any POC type, with
        or without redundant_period, poc_mem_mgmt, ref_reorder, SEI or VUI,
        and a search range of 24 at most (jm_tpu _pipe_ok; both device P
        steps raise above 16, so the range decides only where the stream
        raises); everything else takes the per-frame path."""
        cfg = self.cfg
        return (self._device_path_ok(weighted=bool(cfg.weighted_pred))
                and cfg.num_ref == 1 and cfg.sp_periodicity == 0
                and cfg.num_b == 0 and cfg.entropy == "cavlc"
                and cfg.intra_mb_refresh == 0
                and cfg.slice_mode == 0 and cfg.num_slice_groups == 1
                and self.rc is None and cfg.qp_p is None and cfg.deblock
                and cfg.long_term_period == 0 and cfg.data_partition == 0
                and not cfg.rdoq and not cfg.rd_picture_decision
                and cfg.num_views == 1 and cfg.search_range <= 24)

    # ------------------------------------------------------------------

    def _upload(self, frame) -> torch.Tensor:
        """Y on top, U | V side by side below, in one host buffer and one
        copy to the device."""
        Y, U, V = (np.asarray(p, np.uint8) for p in frame)
        ch = 8 * self.cfg.chroma_format            # chroma rows per MB
        if Y.shape != (16 * self.mb_h, 16 * self.mb_w) \
                or U.shape != (ch * self.mb_h, 8 * self.mb_w) \
                or V.shape != U.shape:
            raise ValueError(f"frame planes {Y.shape}/{U.shape}/{V.shape} "
                             f"do not match {self.cfg.width}x"
                             f"{self.cfg.height} "
                             f"{'4:2:2' if ch == 16 else '4:2:0'}")
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
        Annex-B payloads (bytes). Outside the pipe's cover (``_pipe_ok``)
        every frame takes ``encode_frame``, as jm_tpu's does (with B
        pictures, frames still held back at the end wait for ``flush``,
        as in jm_tpu)."""
        if not self._pipe_ok():
            return [self.encode_frame(*f) for f in frames]
        payloads = []
        pending = None       # (out, disp, state, frame) of the dispatched P
        state = None         # reference for the next dispatch
        for f in frames:
            packed = self._upload(f)
            idx = self.frame_idx + (1 if pending is not None else 0)
            if self._idr_due(idx) or (not self.refs and pending is None):
                if pending is not None:
                    payloads.append(self._finalize(*pending)[0])
                    pending = None
                disp = self.display_idx
                self.display_idx += 1
                payloads.append(self._encode_i(packed, f, disp))
                state = None
                continue
            disp = self.display_idx
            self.display_idx += 1
            out, new_state = self._dispatch(
                packed, state if state is not None else self.refs[0].state)
            if pending is not None:
                payload, fell_back = self._finalize(*pending)
                payloads.append(payload)
                if fell_back:
                    # frame N+1 was speculated against frame N's all-inter
                    # recon: dispatch it again against the corrected one
                    self.redispatches += 1
                    out, new_state = self._dispatch(packed,
                                                    self.refs[0].state)
            pending = (out, disp, new_state, f)
            state = new_state
        if pending is not None:
            payloads.append(self._finalize(*pending)[0])
        return payloads

    def encode_frame(self, Y, U, V, view1=None) -> bytes:
        """Encode one display-order frame on the per-frame path and return
        its Annex-B payload. With num_b the frames between two anchors are
        held back until the next anchor arrives; that call returns the
        anchor and then the B pictures, in coding order, and the others
        b"" (jm_tpu encoder.py:604-631; lencod's frame reordering).
        view1: the dependent view's (Y, U, V) of the same instant, which
        num_views=2 needs (ValueError without it); each access unit's
        view-1 picture follows its view-0 picture (``_emit_view1``)."""
        frame = (Y, U, V)
        disp = self.display_idx
        self.display_idx += 1
        if self.cfg.pic_interlace:
            return self._encode_field_pair(frame, disp)
        if self.cfg.num_views == 2:
            if view1 is None:
                raise ValueError("num_views=2 needs the view1 planes")
            self._v1_pending[disp] = tuple(np.asarray(p, np.uint8)
                                           for p in view1)
        if self.cfg.num_b == 0 or not self.refs:
            return self._emit_anchor(frame, disp)
        self._pending.append((disp, tuple(np.asarray(p, np.uint8)
                                          for p in frame)))
        if len(self._pending) == self.cfg.num_b + 1:
            return self._emit_group()
        return b""

    def flush(self) -> bytes:
        """The end of the stream: the frames held back, the last one coded
        as a P anchor, then the Bs before it."""
        return self._emit_group() if self._pending else b""

    def _emit_anchor(self, frame, disp: int, force=None) -> bytes:
        """An I or P anchor (jm_tpu _emit_anchor): I when intra is due
        (an IDR, or with num_b after the first an open-GOP I), else P on
        the per-frame path against list0's num_ref_active heads; force
        (the explicit sequence coder's {"intra", "idr"}) overrides the
        type. A P picture with basic units of rate control (a positive
        target under rc_basic_unit) is coded by the host P coder, and so
        is an SP picture: with sp_periodicity, the anchor whose frame_idx
        it divides, when not intra, at qp_sp (jm_tpu :1205-1207,
        :1222-1223)."""
        cfg = self.cfg
        packed = self._upload(frame)
        intra = self._idr_due(self.frame_idx)
        idr = self.frame_idx == 0 or cfg.num_b == 0
        if force is not None:
            intra = bool(force.get("intra", intra))
            idr = bool(force.get("idr", idr))
        self.num_ref_active = max(1, min(cfg.num_ref, len(self.refs)))
        if intra:
            return self._encode_i(packed, frame, disp, idr=idr)
        qp = self.rc.pict_qp("P") if self.rc is not None else \
            (cfg.qp if cfg.qp_p is None else cfg.qp_p)
        sp = cfg.sp_periodicity > 0 and \
            self.frame_idx % cfg.sp_periodicity == 0
        if sp:
            qp = cfg.qp_sp
        forced = self._refresh_set()
        units = (self.rc is not None and cfg.rc_basic_unit > 0
                 and self.rc.target > 0)
        if sp or not self._device_path_ok(weighted=bool(cfg.weighted_pred),
                                          basic_units=units):
            return self._encode_p_host(packed, frame, disp, forced, qp, units,
                                       sp=sp)
        ref = self._ref_list_p(2 * (disp - self._idr_disp))[0]
        core = self._p_step(packed, ref, qp)
        return self._finish_p(core, disp, frame, forced, qp, packed)

    # ---- B pictures (jm_tpu encoder.py:989-1051, 1706-1855) ------------

    def _emit_group(self) -> bytes:
        """The anchor that closes a group of held-back frames, then its B
        pictures: one after the other, as a dyadic pyramid, or in the
        explicit GOP string's order."""
        (disp, frame), bs = self._pending[-1], self._pending[:-1]
        self._pending = []
        prev_anchor = self.refs[0]
        out = self._emit_anchor(frame, disp)
        next_anchor = self.refs[0]
        if self.cfg.explicit_gop and bs:
            out += self._emit_b_explicit(bs)
        elif self.cfg.hierarchical and bs:
            out += self._emit_b_pyramid(bs, 0, len(bs) - 1, 1)
        else:
            for bdisp, bframe in bs:
                out += self._emit_b(bframe, bdisp, prev_anchor, next_anchor)
        return out

    def _emit_b_explicit(self, bs) -> bytes:
        """The Bs in the GOP string's order, with its reference flags and
        QP offsets; each predicts from the nearest references by POC."""
        out = b""
        for e in parse_explicit_hierarchy(self.cfg.explicit_gop):
            if e.display_no >= len(bs):
                continue                 # a trailing partial group
            disp, frame = bs[e.display_no]
            poc = 2 * (disp - self._idr_disp)
            lower = [f for f in self.refs if f.poc < poc]
            higher = [f for f in self.refs if f.poc > poc]
            l0 = max(lower, key=lambda f: f.poc)
            l1 = min(higher, key=lambda f: f.poc) if higher else l0
            out += self._emit_b(frame, disp, l0, l1, as_ref=e.as_ref,
                                qp_offset=e.qp_offset)
        return out

    def _emit_b_pyramid(self, bs, lo: int, hi: int, layer: int) -> bytes:
        """The dyadic pyramid of bs[lo..hi]: the middle picture first, a
        reference B unless it is a leaf, at layer's QP offset; then each
        half. The nearest references by POC are the decoder's default
        list heads."""
        if lo > hi:
            return b""
        mid = (lo + hi) // 2
        disp, frame = bs[mid]
        poc = 2 * (disp - self._idr_disp)
        l0 = max((f for f in self.refs if f.poc < poc), key=lambda f: f.poc)
        l1 = min((f for f in self.refs if f.poc > poc), key=lambda f: f.poc)
        out = self._emit_b(frame, disp, l0, l1, as_ref=hi > lo, layer=layer)
        out += self._emit_b_pyramid(bs, lo, mid - 1, layer + 1)
        return out + self._emit_b_pyramid(bs, mid + 1, hi, layer + 1)

    def _ref_mod_ops(self, default_list, target):
        """One ref_pic_list_modification command that puts target at
        index 0 (spec 8.2.4.3), or None when it is there already."""
        if default_list and default_list[0] is target:
            return None
        if target.is_long_term:
            return [(2, target.long_term_frame_idx)]
        diff = self.frame_num - self._picnum(target)
        return [(0, diff - 1)] if diff > 0 else [(1, -diff - 1)]

    def _emit_b(self, frame, disp: int, prev_anchor: Picture,
                next_anchor: Picture, as_ref: bool = False, layer: int = 1,
                qp_offset: int | None = None) -> bytes:
        """One B picture predicting from prev_anchor (list 0) and
        next_anchor (list 1), a non-reference picture unless as_ref: the
        device's integer search tables, the serial host B coder
        (encoder/b_host.py), boundary strengths + deblock + reference prep
        on the device, the host serializer (with slice_mode 2 the picture
        re-coded until its slices fit, the DPB reset before each try, as
        jm_tpu does; with weighted_bipred the tables first). results
        records the wall seconds of each step and the MB decisions."""
        cfg = self.cfg
        poc = 2 * (disp - self._idr_disp)
        if self.rc is not None:
            qp = self.rc.pict_qp("B")
        elif qp_offset is not None:      # the GOP string's offset
            qp = max(0, min(51, cfg.qp + qp_offset))
        else:
            qp = cfg.qp_b if cfg.qp_b is not None else cfg.qp + 2
            qp = min(51, qp + max(0, layer - 1))   # temporal-layer offset
        split = {}
        t = time.perf_counter()
        wp_l0 = wp_l1 = wp = None
        if cfg.weighted_bipred:
            # each list's reference's table (jm_tpu encoder.py:1723-1736)
            if cfg.weighted_bipred == 1:
                est = estimate_lms if cfg.wp_method == 1 \
                    else estimate_explicit
                wp_l0 = est(*frame, [prev_anchor])
                wp_l1 = est(*frame, [next_anchor])
            wp = build_wp_params(SliceType.B, self.pps, [prev_anchor],
                                 [next_anchor], poc, wp_l0, wp_l1)
        t, split["estimate_s"] = time.perf_counter(), \
            time.perf_counter() - t
        packed = self._upload(frame)
        srcY = self._planes(packed)[0]
        anchors = (prev_anchor, next_anchor)
        # with search_mode 1-3 each list's searcher over its reference
        # (jm_tpu :2147-2158), else the 16x16 tables
        makers = [self._searcher(np.asarray(frame[0], np.uint8), [f], qp)
                  for f in anchors]
        sads = [None, None]
        if makers[0] is None:
            makers = None
            sads = [E.full_search_sad16(srcY, f.state[0][0], self.mb_w,
                                        self.mb_h, cfg.search_range)
                    .cpu().numpy() for f in anchors]
        refs = (prev_anchor.host_ref(), next_anchor.host_ref())
        t, split["sad_s"] = time.perf_counter(), time.perf_counter() - t
        m = next_anchor.motion
        col = ColMotion(m[0], m[1], m[2], m[3], self.mb_w,
                        next_anchor.is_long_term, m[4], m[5])
        picture = Picture(poc, self.frame_num, None, -1)
        snapshot = list(self.refs), self._uid
        split["host_mb_s"] = split["serialize_s"] = 0.0

        def code(plan):
            t0 = time.perf_counter()
            b = BPicture(frame, qp, chroma_qp(
                qp, self.pps.chroma_qp_index_offset), lambda_me(qp),
                lambda_mode4(qp), *refs, col, *sads, plan, cfg.search_range,
                wp, transform8x8=cfg.transform8x8, searchers=makers,
                subpel_satd=cfg.subpel_satd, **self._quant_kw("B"))
            split["host_mb_s"] += time.perf_counter() - t0
            return b

        def serialize(pic, plan, sizes):
            # the DPB as the decoder has it when it parses the slices: a
            # reference B stored (from the state before each try), then
            # the default lists (ref_lists_b), modified where a chosen
            # reference is not at index 0
            t0 = time.perf_counter()
            self.refs, self._uid = list(snapshot[0]), snapshot[1]
            if as_ref:
                picture.uid = self._uid
                self._uid += 1
                self._store_ref(picture)
            d0, d1 = ref_lists_b(self.refs, poc)
            out = self._picture_nals(
                pic, SliceType.B, poc, qp, plan, sizes,
                nal_ref_idc=2 if as_ref else 0, is_ref=as_ref,
                ref_mod_l0=self._ref_mod_ops(d0, prev_anchor),
                ref_mod_l1=self._ref_mod_ops(d1, next_anchor),
                wp_l0=wp_l0, wp_l1=wp_l1)
            split["serialize_s"] += time.perf_counter() - t0
            return out

        b, (payload, info), plan = self._fit_slices(code, serialize)
        t = time.perf_counter()
        dY, dU, dV = self._loop_filter(b.rec, b.pic)
        picture.state = E.prep_ref(dY, dU, dV)
        if as_ref:
            picture.motion = _motion(b.pic)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        split["deblock_s"] = time.perf_counter() - t
        payload = self._prefix(False, 2 if as_ref else 0) + payload + \
            self._emit_view1(disp, picture, poc, anchor=False,
                             b_anchors=(prev_anchor, next_anchor),
                             as_ref=as_ref, qp_view=qp)
        if as_ref:
            self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self._rc_update("B", qp, payload, srcY, dY)
        self.results.append({"disp": disp, "type": "B",
                             "bits": len(payload) * 8, "frame": picture,
                             "qp": qp, "slices": len(plan), "ref": as_ref,
                             "split": split, "mix": b.mix, **info})
        return payload

    # ---- MVC stereo (jm_tpu encoder.py:1383-1416, :1604-1706) ----------

    def _prefix(self, idr: bool, nal_ref_idc: int = 3) -> bytes:
        """With two views, the prefix NAL unit (type 14, H.7.4.1.2) that
        announces a base-view picture's slices, else b""."""
        if self.cfg.num_views == 1:
            return b""
        return annexb_bytes(nal_ref_idc, NalUnitType.PREFIX, b"",
                            mvc_ext=mvc_ext_bytes(0 if idr else 1, 0,
                                                  1 if idr else 0, 1))

    def _emit_view1(self, disp: int, v0: Picture, poc: int, anchor: bool,
                    b_anchors=None, as_ref: bool = True,
                    qp_view=None) -> bytes:
        """The dependent-view picture of the access unit whose view-0
        picture v0 was just coded (jm_tpu _emit_view1; lencod.c:894-952),
        or b"" with one view. Every view-1 picture is coded by the host
        coders, as jm_tpu's _device_path_ok (``not is_view1``) has it,
        with the search tables and the deblock on the device, at
        (qp_view, else qp) + view1_qp_offset clamped to 0..51: so its P
        pictures take qp whatever qp_p or rate control say (ROADMAP Queue
        3). An anchor (with a base IDR) is a P picture predicting from v0
        alone, and view 1's references are flushed; any other P picture
        predicts from v0 then the first num_ref of view 1's references,
        with the inter-view command (5, 0) that puts v0 first in the
        decoder's list; a B picture (b_anchors: the view-0 anchors of the
        view-0 B) from the view-1 companions of those anchors, without
        inter-view reference, with list commands against ref_lists_b of
        view 1's references. Deblocked (K1 / K2 on the card), stored
        under view 1's sliding window when a reference, recorded in
        ``results_v1``, serialized as NAL 20 slices of nal_ref_idc 3 (P),
        2 (reference B) or 0, CAVLC or CABAC (the best of the three
        context models with cabac_adapt_init)."""
        cfg = self.cfg
        if cfg.num_views == 1:
            return b""
        t = time.perf_counter()
        frame = self._v1_pending.pop(disp)
        qp = max(0, min(51, (cfg.qp if qp_view is None else qp_view)
                        + cfg.view1_qp_offset))
        qpc = chroma_qp(qp, self.pps.chroma_qp_index_offset)
        srcY = self._planes(self._upload(frame))[0]
        hdr = {"ref_mod_l0": None}
        if b_anchors:
            stype = SliceType.B
            prev, nxt = (self._v1_of[a.uid] for a in b_anchors)
            makers = [self._searcher(frame[0], [f], qp) for f in (prev, nxt)]
            sads = [None, None]
            if makers[0] is None:
                makers = None
                sads = [E.full_search_sad16(srcY, f.state[0][0], self.mb_w,
                                            self.mb_h, cfg.search_range)
                        .cpu().numpy() for f in (prev, nxt)]
            m = nxt.motion
            col = ColMotion(m[0], m[1], m[2], m[3], self.mb_w,
                            nxt.is_long_term, m[4], m[5])
            coded = BPicture(frame, qp, qpc, lambda_me(qp), lambda_mode4(qp),
                             prev.host_ref(), nxt.host_ref(), col, *sads,
                             self.slice_plan, cfg.search_range, None,
                             transform8x8=cfg.transform8x8, searchers=makers,
                             subpel_satd=cfg.subpel_satd,
                             **self._quant_kw("B"))
            nref = 1
        else:
            stype = SliceType.P
            if anchor:
                self.refs_v1 = []
                refs = [v0]
            else:
                nact = max(1, min(cfg.num_ref, len(self.refs_v1)))
                refs = [v0] + self.refs_v1[:nact]
                hdr["ref_mod_l0"] = [(5, 0)]   # abs_diff_view_idx_minus1
            nref = len(refs)
            sads, blk4 = self._search_tables(srcY, refs)
            coded = PPicture(frame, qp, qpc, lambda_me(qp), lambda_mode4(qp),
                             [r.host_ref() for r in refs], sads,
                             self.slice_plan, cfg.search_range,
                             transform8x8=cfg.transform8x8, blk4=blk4,
                             searcher=self._searcher(frame[0], refs, qp),
                             sub8x8=cfg.sub8x8, subpel_satd=cfg.subpel_satd,
                             **self._quant_kw("P"))
        pic = coded.pic
        dec = self._loop_filter(coded.rec, pic)
        picture = Picture(poc, self.frame_num, E.prep_ref(*dec) if as_ref
                          else None, -1, None if as_ref
                          else tuple(p.cpu().numpy() for p in dec))
        if as_ref:
            picture.uid = self._uid
            self._uid += 1
            picture.motion = _motion(pic)
            # view 1's sliding window, reference Bs included, as the
            # decoder's view-1 DPB keeps it
            self.refs_v1.insert(0, picture)
            del self.refs_v1[self.dpb_size:]
            live = {f.uid for f in self.refs}
            self._v1_of = {u: f for u, f in self._v1_of.items() if u in live}
            self._v1_of[v0.uid] = picture
        if stype == SliceType.B:
            d0, d1 = ref_lists_b(self.refs_v1, poc)
            hdr.update(ref_mod_l0=self._ref_mod_ops(d0, prev),
                       ref_mod_l1=self._ref_mod_ops(d1, nxt),
                       num_ref_idx_l1=1, is_ref=as_ref)
        kw = dict(slice_type=stype, frame_num=self.frame_num, idr=anchor,
                  qp=qp, idr_pic_id=self.idr_pic_id, poc_lsb=poc % 256,
                  num_ref_idx_l0=nref, **hdr)
        ext = mvc_ext_bytes(0 if anchor else 1, 1, 1 if anchor else 0, 0)
        nri = (3 if stype == SliceType.P else 2) if as_ref else 0
        out, bins = b"", 0
        for addrs in self.slice_plan:
            if cfg.entropy == "cabac":
                rbsp, b, _idc = self._serialize_cabac_best_init(
                    pic, mb_addrs=addrs, **kw)
                bins += b
            else:
                rbsp = serialize_slice(
                    pic, self.sps, self.pps, mb_addrs=addrs,
                    slice_group_change_cycle=cfg.sg_change_cycle, **kw)
            out += annexb_bytes(nri, NalUnitType.SLICE_EXT, rbsp,
                                mvc_ext=ext)
        if cfg.entropy == "cabac":
            out += self._cabac_zero_words(out, bins, len(self.slice_plan))
        self.results_v1.append({"disp": disp, "type": stype.name,
                                "anchor": anchor, "bits": len(out) * 8,
                                "frame": picture, "qp": qp, "ref": as_ref,
                                "seconds": time.perf_counter() - t})
        return out

    # ---- field pictures (jm_tpu encoder.py:1049-1188) -------------------

    def _encode_field_pair(self, frame, disp: int) -> bytes:
        """A display frame as two field pictures, the top (even lines)
        then the bottom one (jm_tpu _encode_field_pair; lencod image.c:751
        perform_encode_field), one frame_num for both."""
        planes = tuple(np.asarray(p, np.uint8) for p in frame)
        out = b"".join(self._encode_field(tuple(p[parity::2] for p in planes),
                                          disp, parity) for parity in (0, 1))
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        return out

    def _encode_field(self, field, disp: int, parity: int) -> bytes:
        """One field picture of parity (0 top, 1 bottom; jm_tpu
        _encode_field): the top field of an IDR frame is an IDR I field
        (SPS and PPS before it) and every other field a P field at qp
        (qp_p, rd_picture_decision, intra_mb_refresh and the user-data SEI
        are read nowhere here, as in jm_tpu), over the first 2 num_ref
        entries of the decoder's field list0 (dpb.field_ref_list_p), the
        bottom field of an IDR frame predicting from its top field. Coded by the serial host coders
        with the field scan (IntraPicture, or PPicture over the quadrant
        SAD tables of its reference fields on the device, or its
        searcher), deblocked on the device with the field rules, stored as
        a reference field under the decoder's sliding window of frame
        units (dpb.field_window, num_ref units)."""
        cfg = self.cfg
        idr = parity == 0 and self._idr_due(self.frame_idx)
        if idr:
            self.frame_num = 0
            self._idr_disp = disp
            self.refs = []
        poc = 2 * (disp - self._idr_disp) + parity
        qp = cfg.qp
        qpc = chroma_qp(qp, self.pps.chroma_qp_index_offset)
        packed = self._upload(field)
        if idr:
            coded = IntraPicture(field, qp, qpc, lambda_me(qp),
                                 lambda_mode4(qp), self.slice_plan,
                                 parity=parity, **self._quant_kw("I"))
        else:
            full = field_ref_list_p(self.refs, parity, self._picnum)
            self.num_ref_active = max(1, min(2 * cfg.num_ref, len(full)))
            refs = full[:self.num_ref_active]
            sads, blk4 = self._search_tables(self._planes(packed)[0], refs)
            coded = PPicture(field, qp, qpc, lambda_me(qp), lambda_mode4(qp),
                             [r.host_ref() for r in refs], sads,
                             self.slice_plan, cfg.search_range, blk4=blk4,
                             searcher=self._searcher(field[0], refs, qp),
                             sub8x8=cfg.sub8x8, subpel_satd=cfg.subpel_satd,
                             parity=parity, **self._quant_kw("P"))
        pic = coded.pic
        pic.field_mode = True
        dec = self._loop_filter(coded.rec, pic)
        nal, _info = self._picture_nals(
            pic, SliceType.I if idr else SliceType.P, poc, qp,
            self.slice_plan, idr=idr, field_pic=1, bottom_field=parity)
        frame = self._new_picture(poc, E.prep_ref(*dec), planes=tuple(
            t.cpu().numpy() for t in dec) if idr else None)
        frame.parity = parity
        frame.motion = _motion(pic)
        self.refs = field_window([frame] + self.refs,
                                 self.sps.max_num_ref_frames)
        payload = b""
        if idr:
            payload = (annexb_bytes(3, NalUnitType.SPS,
                                    write_sps(self.sps, self.sps_scaling))
                       + annexb_bytes(3, NalUnitType.PPS,
                                      write_pps(self.pps, self.pps_scaling)))
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        payload += nal
        info = {} if idr else {"mix": coded.mix, "mb_parts": coded.part_s}
        self.results.append({"disp": disp, "type": "I" if idr else "P",
                             "parity": parity, "bits": len(payload) * 8,
                             "frame": frame, "qp": qp,
                             "slices": len(self.slice_plan), **info})
        return payload

    def _p_step(self, packed, ref: Picture, qp: int, reuse=None,
                frame=None):
        """The device P step of the uploaded frame (packed; None: upload
        frame) against ref at qp, in jm_tpu _encode_p_device's order
        (encoder.py:2221-2241): md_low with sp_shards > 1 dividing mb_h
        and a range of 16 at most runs sharded by MB rows
        (parallel/sp_pipeline.py, counted in sp_steps) over _sp_mesh, or
        else over make_sp_mesh(sp_shards) of the encoder's device type,
        which raises with fewer devices; else reuse, the pipe's encode of
        this frame, when given; else ops/enc.p_frame_step."""
        cfg = self.cfg
        qpc = chroma_qp(qp, self.pps.chroma_qp_index_offset)
        if (cfg.sp_shards > 1 and self.mb_h % cfg.sp_shards == 0
                and cfg.search_range <= 16 and not cfg.device_rd):
            if self._sp_mesh is None or len(self._sp_mesh) != cfg.sp_shards:
                self._sp_mesh = make_sp_mesh(cfg.sp_shards,
                                             device_type=self.device.type)
            if packed is None:
                packed = self._upload(frame)
            p = E.PAD
            planes, padU, padV = ref.state
            out = p_frame_step_sharded(
                self._sp_mesh, *self._planes(packed), planes[0, p:-p, p:-p],
                padU[p:-p, p:-p], padV[p:-p, p:-p], qp, qpc, lambda_me(qp),
                lambda_mode4(qp), mb_w=self.mb_w, mb_h=self.mb_h,
                sr=cfg.search_range)
            self.sp_steps += 1
            return out
        if reuse is not None:
            return reuse
        return E.p_frame_step(
            *self._planes(packed), *ref.state, qp, qpc, lambda_me(qp),
            lambda_mode4(qp), mb_w=self.mb_w, mb_h=self.mb_h,
            sr=cfg.search_range, rd=cfg.device_rd)

    # ---- the DPB (jm_tpu encoder.py:501-578) ---------------------------

    def _ref_list_p(self, poc: int) -> list:
        """List0 of the P picture of POC poc being coded, as the decoder
        builds it: the short-term references (by PicNum descending, which
        is insertion order here; with ref_reorder by POC distance), then
        the long-term ones; num_ref_active entries are active."""
        st = [f for f in self.refs if not f.is_long_term]
        if self.cfg.ref_reorder == 1:
            st.sort(key=lambda f: (abs(f.poc - poc), 0 if f.poc > poc else 1))
        lt = sorted((f for f in self.refs if f.is_long_term),
                    key=lambda f: f.long_term_frame_idx)
        return (st + lt)[:self.num_ref_active]

    def _picnum(self, f: Picture) -> int:
        """PicNum of a short-term reference (spec 8.2.4.1)."""
        return (f.frame_num if f.frame_num <= self.frame_num
                else f.frame_num - self.sps.max_frame_num)

    def _poc_reorder_cmds(self, poc: int):
        """The ref_pic_list_modification commands that turn the decoder's
        default list0 into _ref_list_p's order (lencod list_reorder.c
        :196-238, stopping once the rest matches), or None."""
        default = [f for f in self.refs
                   if not f.is_long_term][:self.num_ref_active]
        target = [f for f in self._ref_list_p(poc) if not f.is_long_term]
        n = len(target)
        if [id(f) for f in target] == [id(f) for f in default[:n]]:
            return None
        max_fn = self.sps.max_frame_num
        cmds = []
        pred = self.frame_num
        cur = [self._picnum(f) for f in default]
        want = [self._picnum(f) for f in target]
        for i, pn in enumerate(want):
            diff = pn - pred
            if diff <= 0:
                amp = -diff - 1
                cmds.append((0, max_fn - 1 if amp < 0 else amp))
            else:
                cmds.append((1, diff - 1))
            pred = pn
            rest = [x for x in cur[i:] if x != pn]
            cur = cur[:i] + [pn] + rest
            if cur[i + 1:n] == want[i + 1:]:
                break
        return cmds

    def _poc_mmco(self):
        """poc_mem_mgmt: with the DPB full, MMCO 1 unmarks the short-term
        reference of least POC (lencod mmco.c
        poc_based_ref_management_frame_pic:300). Returns (commands,
        victim) or (None, None)."""
        st = [f for f in self.refs if not f.is_long_term]
        if len(self.refs) != self.sps.max_num_ref_frames or not st:
            return None, None
        victim = min(st, key=lambda f: f.poc)
        return ((1, self.frame_num - self._picnum(victim) - 1),), victim

    def _anchor_marking(self, poc: int, intra: bool = False):
        """The marking of the non-IDR anchor of POC poc being coded, a P
        picture or (intra) an open-GOP I (jm_tpu _emit_anchor): (whether
        it becomes the long-term anchor, the slice header's marking and
        list-modification keywords, the references that its MMCO 1
        commands unmark). The CRA marking and list modification are a P
        picture's."""
        cfg = self.cfg
        lt = cfg.long_term_period > 0 and \
            self.frame_idx % cfg.long_term_period == 0
        mmco, victims = (((4, 1), (6, 0)) if lt else None), []
        if cfg.poc_mem_mgmt == 1 and mmco is None:
            mmco, victim = self._poc_mmco()
            victims = [victim] if victim is not None else []
        if cfg.mmco_policy == "cra" and mmco is None and not intra \
                and self._cra_poc is not None:
            # cra_ref_management_frame_pic (lencod mmco.c:151): MMCO 1 for
            # every short-term reference before the last open-GOP I
            victims = [f for f in self.refs if not f.is_long_term
                       and f.poc < self._cra_poc]
            if victims:
                mmco = tuple((1, self.frame_num - self._picnum(f) - 1)
                             for f in victims)
                self._cra_poc = None
        if intra:
            return lt, {"mmco_ops": mmco}, victims
        ref_mod = self._poc_reorder_cmds(poc) if cfg.ref_reorder == 1 \
            else None
        return lt, {"mmco_ops": mmco, "ref_mod_l0": ref_mod}, victims

    def _store_ref(self, frame: Picture, long_term: bool = False) -> None:
        """Store a coded picture as the newest reference (the decoder's
        DPB.store: a new long-term anchor takes index 0 from its holder;
        the sliding window spares long-term pictures)."""
        if long_term:
            self.refs = [f for f in self.refs if not (
                f.is_long_term and f.long_term_frame_idx == 0)]
            frame.is_long_term = True
            frame.long_term_frame_idx = 0
        self.refs.insert(0, frame)
        st = [f for f in self.refs if not f.is_long_term]
        while len(self.refs) > self.dpb_size and st:
            self.refs.remove(st.pop())

    def _new_picture(self, poc: int, state, planes=None) -> Picture:
        frame = Picture(poc, self.frame_num, state, self._uid, planes)
        self._uid += 1
        return frame

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

    def _deblock(self, rec, pic: PictureData):
        """Boundary strengths + deblock of a coded picture on the device:
        rec the (Y, U, V) recon planes (device tensors or numpy), pic its
        PictureData (per-MB QP, slice id and transform8x8, whose inner 4x4
        edges the filter skips; the MVs and reference ids of both lists,
        -1 for intra MBs and unused lists; the MBs of SP slices, whose
        edges take bS 3 / 4). Returns the
        deblocked planes on the device."""
        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        rec = tuple(p if isinstance(p, torch.Tensor) else up(p) for p in rec)
        zeros = torch.zeros(pic.n_mbs, dtype=torch.int32, device=self.device)
        t8 = up(pic.transform8x8.astype(np.int32))
        bs_v, bs_h = compute_bs(up(pic.mb_class), up(pic.luma_nnz), t8,
                                up(pic.mv), up(pic.mv_l1), up(pic.ref_pic_id),
                                up(pic.ref_pic_id_l1), self.mb_w, self.mb_h,
                                field=pic.field_mode,
                                sp_slice=up(pic.sp_slice)
                                if pic.sp_slice.any() else None)
        return deblock(*rec, bs_v, bs_h, up(pic.qp), zeros, zeros, zeros,
                       up(pic.slice_id), t8, self.qpc_cb, self.qpc_cr,
                       mb_w=self.mb_w, mb_h=self.mb_h)

    def _loop_filter(self, rec, pic: PictureData):
        """The deblocked planes of a coded picture on the device (the
        recon itself, uploaded where it is on the host, with
        deblock=False)."""
        if self.cfg.deblock:
            return self._deblock(rec, pic)
        return tuple(p if isinstance(p, torch.Tensor) else
                     torch.as_tensor(np.ascontiguousarray(p),
                                     device=self.device) for p in rec)

    def _rc_update(self, label: str, qp: int, payload: bytes, src_y,
                   rec_y) -> None:
        """Rate control's update after a coded picture: its bits and the
        mean absolute difference of the source and deblocked luma (device
        tensors; summed in int64, divided in float64, as numpy's mean)."""
        if self.rc is None:
            return
        diff = (src_y.to(torch.int32) - rec_y.to(torch.int32)).abs()
        mad = int(diff.sum(dtype=torch.int64)) / diff.numel()
        self.rc.update(label, qp, len(payload) * 8, mad)

    def _fit_slices(self, code, serialize):
        """Code and serialize a picture under the slice plan. code(plan)
        returns the coded picture (an object with ``pic``);
        serialize(pic, plan, sizes) its slice NAL units, appending each
        one's size. With slice_mode 2 every slice over slice_argument
        bytes (NAL unit without start code, lencod slice.c:524) is cut in
        proportion and the picture re-coded, at most 12 times, until each
        fits or is one MB (jm_tpu _fit_byte_slices). Returns (the coded
        picture, its serialization, the plan)."""
        limit = self.cfg.slice_argument
        fit = self.cfg.slice_mode == 2 and limit > 0
        plan = [list(a) for a in self.slice_plan]
        for _ in range(12 if fit else 1):
            coded = code(plan)
            sizes = []
            out = serialize(coded.pic, plan, sizes)
            if not fit:
                break
            new_plan, changed = [], False
            for addrs, sz in zip(plan, sizes):
                if sz <= limit or len(addrs) == 1:
                    new_plan.append(addrs)
                    continue
                changed = True
                k = max(1, int(len(addrs) * limit / sz * 0.92))
                new_plan.extend(addrs[i:i + k]
                                for i in range(0, len(addrs), k))
            if not changed:
                break
            plan = new_plan
        return coded, out, plan

    # ---- I pictures ----------------------------------------------------

    def _encode_i(self, packed, frame, disp: int, idr: bool = True) -> bytes:
        """An I picture at qp (or rate control's I QP) on the per-frame
        path, coded on the device when it is one slice, on the host
        otherwise: an IDR (with SPS / PPS and the user-data SEI), or with
        B pictures an open-GOP I (jm_tpu encoder.py:1196-1199), a
        non-IDR reference picture after the recovery point SEI
        (sei_recovery_point) whose POC the next anchors' CRA marking
        reads."""
        cfg = self.cfg
        if idr:
            self.frame_num = 0
            self._idr_disp = disp
        poc = 2 * (disp - self._idr_disp)
        if self.rc is not None:
            gop = cfg.intra_period if cfg.intra_period > 0 else 32
            self.rc.init_gop(gop - 1, gop * cfg.num_b)
            qp = self.rc.pict_qp("I")
        else:
            qp = cfg.qp
        if idr:
            lt = cfg.long_term_period > 0 and \
                self.frame_idx % cfg.long_term_period == 0
            hdr, victims = {"long_term_flag": int(lt)}, []
        else:
            lt, hdr, victims = self._anchor_marking(poc, intra=True)
        planes = self._planes(packed)
        trials = _Trials(self, planes, qp)
        for q in trials.qps:
            trials.start()
            coded, (nal, _info), plan = self._fit_slices(
                lambda plan, q=q: self._code_i(planes, frame, q, plan),
                lambda pic, plan, sizes, q=q: self._picture_nals(
                    pic, SliceType.I, poc, q, plan, sizes, idr=idr, **hdr))
            trials.add(q, nal, self._loop_filter(coded.rec, coded.pic),
                       coded, plan)
        qp, nal, (dY, dU, dV), (coded, plan) = trials.best()
        self._errdo_update(coded.pic, dY)
        payload = b""
        if idr:
            payload = annexb_bytes(3, NalUnitType.SPS,
                                   write_sps(self.sps, self.sps_scaling))
            if cfg.num_views == 2:
                payload += annexb_bytes(
                    3, NalUnitType.SUBSET_SPS,
                    write_subset_sps(self.sps, self.sps_scaling))
            payload += annexb_bytes(3, NalUnitType.PPS,
                                    write_pps(self.pps, self.pps_scaling))
        sei = []
        if idr and cfg.sei_user_data is not None:
            sei.append(user_data_unregistered(cfg.sei_user_data))
        if not idr and cfg.sei_recovery_point:
            # open-GOP random access point (lencod.c:999 EnableOpenGOP)
            sei.append(recovery_point(0, exact_match=True))
        if sei:
            payload += annexb_bytes(0, NalUnitType.SEI, build_sei_rbsp(sei))
        payload += self._prefix(idr) + nal
        frame = self._new_picture(poc, E.prep_ref(dY, dU, dV), planes=tuple(
            t.cpu().numpy() for t in (dY, dU, dV)))
        frame.motion = _motion(coded.pic)
        if idr:
            self.refs = []
        else:
            self._cra_poc = poc
        for victim in victims:
            self.refs.remove(victim)
        self._store_ref(frame, long_term=lt)
        payload += self._emit_view1(disp, frame, poc, anchor=idr)
        self._rc_update("I", qp, payload, planes[0], dY)
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        classes = coded.pic.mb_class
        self.results.append({"disp": disp, "type": "I",
                             "bits": len(payload) * 8, "frame": frame,
                             "qp": qp, "slices": len(plan),
                             "mb_classes": {k: int((classes == c).sum())
                                            for k, c in _INTRA_CLASSES},
                             **trials.info()})
        return payload

    def _code_i(self, planes, frame, qp: int, plan):
        """The I picture under the slice plan: ops/intra.i_frame_step on
        the device route (_device_i_path_ok), else the host intra
        encoder."""
        qpc = chroma_qp(qp, self.pps.chroma_qp_index_offset)
        if not self._device_i_path_ok(plan):
            return self._intra_host(frame, qp, qpc, plan)
        out = i_frame_step(*planes, qp, qpc, lambda_me(qp), lambda_mode4(qp),
                           mb_w=self.mb_w, mb_h=self.mb_h)
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
        return _Coded(pic, (out["recY"], out["recU"], out["recV"]))

    def _intra_host(self, frame, qp: int, qpc: int, plan) -> IntraPicture:
        """The serial host intra encoder over the slice plan."""
        return IntraPicture(frame, qp, qpc, lambda_me(qp), lambda_mode4(qp),
                            plan, **self._quant_kw("I"))

    # ---- P pictures of the pipe ----------------------------------------

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
            # jm_tpu's fallback runs encode_frame with the dispatched
            # encode reused, also by the redundant coding (Queue 3), where
            # the sharded step does not run first
            ref = self._ref_list_p(2 * (disp - self._idr_disp))[0]
            core = self._p_step(None, ref, self.cfg.qp, reuse=out["core"],
                                frame=frame)
            return self._finish_p(core, disp, frame, (), self.cfg.qp,
                                  red_core=out["core"]), True
        poc = 2 * (disp - self._idr_disp)
        motion = None
        if ovf:
            # the picture serialized on the host leaves its motion, as in
            # jm_tpu (the temporal predictors of a later EPZS search)
            self.ovf.append(disp)
            pic = self._inter_picture(out)
            pic.ref_pic_id[:] = self.refs[0].uid
            motion = _motion(pic)
            nal, info = self._serialize_p(pic, disp, self.cfg.qp,
                                          self.slice_plan)
        else:
            k = (nbits + 31) // 32
            bw = BitWriter()
            write_slice_header(bw, self.sps, self.pps,
                               slice_type=SliceType.P,
                               frame_num=self.frame_num, idr=False,
                               idr_pic_id=self.idr_pic_id, qp=self.cfg.qp,
                               poc_lsb=poc % 256,
                               num_ref_idx_l0=self.num_ref_active)
            bw.append_bitstream(ext[3:3 + k].astype(">u4").tobytes(), nbits)
            bw.rbsp_trailing_bits()
            nal, info = annexb_bytes(3, NalUnitType.SLICE, bw.get_bytes()), {}
        return self._commit_p_frame(nal, disp, new_state, self.cfg.qp, 1,
                                    motion=motion, **info), False

    def _commit_p_frame(self, slice_bytes: bytes, disp: int, state, qp: int,
                        n_slices: int, long_term: bool = False, victims=(),
                        motion=None, rc_planes=None, **info) -> bytes:
        """Store a coded P picture (its NAL units slice_bytes, its motion)
        in the DPB, after the references its MMCO 1 commands unmark
        (victims) leave it; with two views its prefix NAL unit before and
        the access unit's view-1 picture after slice_bytes; rate
        control's update (rc_planes: the source and deblocked luma) and
        ``results`` (with the items of info). Returns the payload."""
        poc = 2 * (disp - self._idr_disp)
        frame = self._new_picture(poc, state)
        frame.motion = motion
        for victim in victims:
            # the decoder runs the MMCO before it stores the picture
            # (spec 8.2.5.4.1)
            self.refs.remove(victim)
        self._store_ref(frame, long_term=long_term)
        slice_bytes = self._prefix(False) + slice_bytes + \
            self._emit_view1(disp, frame, poc, anchor=False)
        if rc_planes is not None:
            self._rc_update("P", qp, slice_bytes, *rc_planes)
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        self.results.append({"disp": disp, "type": "P",
                             "bits": len(slice_bytes) * 8, "frame": frame,
                             "qp": qp, "slices": n_slices, **info})
        return slice_bytes

    # ---- the per-frame P path ----------------------------------------

    def _finish_p(self, core, disp: int, frame, forced, qp: int,
                  packed=None, red_core=None) -> bytes:
        """The per-frame P path after the device encode `core`
        (p_frame_step's fields at qp, against the head of list0): download,
        host commit with the intra re-encode under the slice plan
        (re-coded until the slices fit with slice_mode 2), deblock and
        reference prep on the device, host serializer with the picture's
        marking, then the redundant coding when one is due. frame: the
        source (Y, U, V) planes; forced: MBs of the intra refresh; packed:
        the uploaded source (rate control, the redundant encode);
        red_core: a device encode the redundant coding reuses."""
        cfg = self.cfg
        poc = 2 * (disp - self._idr_disp)
        ref = self._ref_list_p(poc)[0]
        lt, hdr, victims = self._anchor_marking(poc)
        trials = _Trials(self, None if packed is None
                         else self._planes(packed), qp)
        for i, q in enumerate(trials.qps):
            trials.start()
            qpc = chroma_qp(q, self.pps.chroma_qp_index_offset)
            host = self._download_core(core if i == 0
                                       else self._p_step(packed, ref, q))
            c, (nal, info), plan = self._fit_slices(
                lambda plan, q=q, qpc=qpc, host=host: self._commit_p(
                    host, frame, forced, q, qpc, plan),
                lambda pic, plan, sizes, q=q: self._serialize_p(
                    pic, disp, q, plan, sizes, **hdr))
            c.pic.ref_pic_id[c.pic.ref_pic_id >= 0] = ref.uid
            dec, state = self._deblock_p(c)
            trials.add(q, nal, dec, c, info, plan, state)
        qp, nal, dec, (c, info, plan, state) = trials.best()
        self._errdo_update(c.pic, dec[0])
        if cfg.redundant_period and \
                self.frame_idx % cfg.redundant_period == 0:
            nal += self._redundant(packed, frame, poc, qp, ref, red_core)
        return self._commit_p_frame(nal, disp, state, qp, len(plan),
                                    long_term=lt, victims=victims,
                                    motion=_motion(c.pic),
                                    rc_planes=None if self.rc is None else
                                    (self._planes(packed)[0], dec[0]),
                                    intra_mbs=len(c.intra_mbs),
                                    ref_poc=ref.poc, **info,
                                    **trials.info())

    def _wp_tables(self, frame, refs, sp: bool = False) -> list:
        """The explicit weight tables a weighted P picture is coded with
        (jm_tpu _emit_anchor :1226-1296), one entry per active reference
        of refs: the estimate (wp_iter_mc, else wp_method), and with
        wp_mcprec and no rate control also the offset-only and the default
        tables (not for an SP picture, sp)."""
        cfg = self.cfg
        if cfg.wp_iter_mc > 0:
            table = estimate_mc_iter(*frame, refs, iters=cfg.wp_iter_mc)
        else:
            est = estimate_lms if cfg.wp_method == 1 else estimate_explicit
            table = est(*frame, refs)
        tables = [table]
        if cfg.wp_mcprec and self.rc is None and not sp:
            tables += [estimate_lms(*frame, refs, select_offset=1),
                       [{"luma": (32, 0), "chroma": ((32, 0), (32, 0))}
                        for _ in refs]]
        return tables

    def _encode_p_host(self, packed, frame, disp: int, forced, qp: int,
                       units: bool = False, sp: bool = False) -> bytes:
        """A P picture coded by the serial host P coder (jm_tpu
        _emit_anchor :1226-1351 with _FrameEncoder's host path): its
        active references (_ref_list_p) downloaded once, with
        weighted_pred their tables (_wp_tables; else one coding without a
        table); the integer search: each reference's quadrant table on the
        device (with sub8x8 its 4x4 table, whose quadrant sums are taken
        on the host), or with search_mode 1-3 the picture's searcher
        (_searcher). Each coding: the host P coder under the slice plan
        (re-coded until the slices fit with slice_mode 2; with units, the
        basic units of rate control afresh), deblock on the device, the
        host serializer with the table in every slice header; of several,
        the coding of least frame-level J = SSD + lambda_mode(qp) 8 bytes
        (the first on a tie). Then the reference prep, the redundant
        coding when one is due, and the DPB. results records the table,
        the wall seconds of each step, the MB decisions, the host MB
        loop's parts, the partitions coded from a later reference (ref1)
        and the searcher's SAD evaluations (evals). sp: an SP picture
        (slice type SP, QS qp_sp2, no redundant coding)."""
        cfg = self.cfg
        poc = 2 * (disp - self._idr_disp)
        sp_qs = (cfg.qp_sp2, chroma_qp(cfg.qp_sp2,
                                       self.pps.chroma_qp_index_offset)) \
            if sp else None
        refs = self._ref_list_p(poc)
        lt, hdr, victims = self._anchor_marking(poc)
        frame = tuple(np.asarray(p, np.uint8) for p in frame)
        split = {}
        t = time.perf_counter()
        hosts = [r.host_ref() for r in refs]
        if cfg.weighted_pred:
            for r in refs:
                _ = r.Y                  # the deblocked planes, once
        t, split["download_s"] = time.perf_counter(), \
            time.perf_counter() - t
        tables = self._wp_tables(frame, refs, sp) if cfg.weighted_pred \
            else [None]
        t, split["estimate_s"] = time.perf_counter(), \
            time.perf_counter() - t
        planes = self._planes(packed)
        sads, blk4 = self._search_tables(planes[0], refs)
        split["sad_s"] = time.perf_counter() - t
        split["host_mb_s"] = split["serialize_s"] = split["deblock_s"] = 0.0
        trials = _Trials(self, planes, qp, extra=len(tables) - 1)
        # rd_picture_decision's QPs with the first table, then wp_mcprec's
        # tables at qp (jm_tpu :1281-1303)
        codings = [(q, tables[0]) for q in trials.qps] + \
            [(qp, t) for t in tables[1:]]
        for q, table in codings:
            trials.start()
            wp = None if table is None else build_wp_params(
                SliceType.P, self.pps, refs, [], poc, wp_l0=table)

            def code(plan, q=q, wp=wp):
                t0 = time.perf_counter()
                c = PPicture(frame, q, chroma_qp(
                    q, self.pps.chroma_qp_index_offset), lambda_me(q),
                    lambda_mode4(q), hosts, sads, plan, cfg.search_range,
                    forced, wp, transform8x8=cfg.transform8x8, blk4=blk4,
                    searcher=self._searcher(frame[0], refs, q),
                    sub8x8=cfg.sub8x8, subpel_satd=cfg.subpel_satd,
                    units=_BasicUnits(self, q) if units else None,
                    sp=sp_qs, **self._quant_kw("P"))
                split["host_mb_s"] += time.perf_counter() - t0
                return c

            def serialize(pic, plan, sizes, q=q, table=table):
                t0 = time.perf_counter()
                out = self._serialize_p(pic, disp, q, plan, sizes,
                                        wp_l0=table, sp=sp, **hdr)
                split["serialize_s"] += time.perf_counter() - t0
                return out

            c, (nal, info), plan = self._fit_slices(code, serialize)
            t = time.perf_counter()
            dec = self._loop_filter(c.rec, c.pic)
            trials.add(q, nal, dec, c, info, plan, table)
            split["deblock_s"] += time.perf_counter() - t
        qp, nal, dec, (c, info, plan, table) = trials.best()
        self._errdo_update(c.pic, dec[0])
        t = time.perf_counter()
        state = E.prep_ref(*dec)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        split["deblock_s"] += time.perf_counter() - t
        if cfg.redundant_period and not sp and \
                self.frame_idx % cfg.redundant_period == 0:
            nal += self._redundant(
                packed, frame, poc, qp, refs[0],
                sads=None if sads is None else sads[:1],
                blk4=None if blk4 is None else blk4[:1])
        if units:
            info.update(mb_qps=tuple(int(q) for q in np.unique(c.pic.qp)),
                        qp_unsent=_qp_unsent(c.pic, plan, qp))
        if sp:
            info["sp"] = True
        return self._commit_p_frame(nal, disp, state, qp, len(plan),
                                    long_term=lt, victims=victims,
                                    motion=_motion(c.pic),
                                    rc_planes=(planes[0], dec[0]),
                                    intra_mbs=sum(c.mix[k] for k in (
                                        "i16", "i4", "ipcm")),
                                    ref_poc=refs[0].poc, wp_l0=table,
                                    split=split, mix=c.mix,
                                    mb_parts=c.part_s, ref1=c.ref1,
                                    evals=c.evals, **info, **trials.info())

    def _search_tables(self, srcY, refs):
        """The full search's integer tables against each reference on
        the device, downloaded: (quadrant tables, 4x4 tables with sub8x8
        else None); (None, None) when a searcher searches
        (search_mode 1-3)."""
        cfg = self.cfg
        if cfg.search_mode >= 1:
            return None, None
        args = (self.mb_w, self.mb_h, cfg.search_range)
        if not cfg.sub8x8:
            return [E.full_search_sad_quad(srcY, r.state[0][0], *args)
                    .cpu().numpy() for r in refs], None
        blk4 = [E.full_search_sad_blk4(srcY, r.state[0][0], *args)
                .cpu().numpy() for r in refs]
        return [b[:, :, QUAD_BLKS].sum(axis=3, dtype=np.int32)
                for b in blk4], blk4

    def _searcher(self, srcY, refs, qp: int):
        """With search_mode 1-3, the maker of a picture's searcher over
        refs (Pictures) from its motion field (UMHex, UMHex simple or
        EPZS, at lambda_me(qp), with hme's predictors: jm_tpu
        _FrameEncoder.encode :2118-2160); else None."""
        cfg = self.cfg
        if cfg.search_mode < 1:
            return None
        cls = {1: UMHexSearcher, 2: UMHexSmpSearcher}.get(cfg.search_mode,
                                                           EPZSearcher)
        return lambda mv: cls(srcY, refs, self.mb_w, self.mb_h,
                              cfg.search_range, lambda_me(qp), mv,
                              use_hme=cfg.hme)

    def _redundant(self, packed, frame, poc: int, qp: int, ref: Picture,
                   core=None, sads=None, blk4=None) -> bytes:
        """The redundant coding of the P picture just coded (jm_tpu
        _emit_redundant, lencod.c:2225-2352): the frame coded again at
        qp + redundant_qp_off (at most 51) against the primary's first
        reference ref, without weighted prediction, intra refresh or basic
        units: on the device route a device encode (or core reused) and
        the host commit, else the host P coder over the primary's search
        tables of ref (sads, blk4) or its own searcher; under the slice
        plan, then one slice with redundant_pic_cnt 1, nal_ref_idc 0, one
        active reference and no marking. Decoders that have the primary
        discard it; it is neither deblocked nor stored."""
        cfg = self.cfg
        qp_r = min(51, qp + cfg.redundant_qp_off)
        qpc_r = chroma_qp(qp_r, self.pps.chroma_qp_index_offset)
        if self._device_path_ok():
            core = self._p_step(packed, ref, qp_r, reuse=core, frame=frame)
            c = self._commit_p(self._download_core(core), frame, (), qp_r,
                               qpc_r, self.slice_plan)
        else:
            c = PPicture(frame, qp_r, qpc_r, lambda_me(qp_r),
                         lambda_mode4(qp_r), [ref.host_ref()], sads,
                         self.slice_plan, cfg.search_range,
                         transform8x8=cfg.transform8x8, blk4=blk4,
                         searcher=self._searcher(frame[0], [ref], qp_r),
                         sub8x8=cfg.sub8x8, subpel_satd=cfg.subpel_satd,
                         num_ref=self.num_ref_active, **self._quant_kw("P"))
        return annexb_bytes(0, NalUnitType.SLICE, self._serialize_redundant(
            c.pic, poc, qp_r))

    def _serialize_redundant(self, pic: PictureData, poc: int,
                             qp: int) -> bytes:
        """The redundant coding's slice RBSP, whatever the entropy coder
        of the stream (jm_tpu writes it with its CAVLC serializer:
        Queue 3)."""
        return serialize_slice(pic, self.sps, self.pps,
                               slice_type=SliceType.P,
                               frame_num=self.frame_num, idr=False, qp=qp,
                               poc_lsb=poc % 256, redundant_pic_cnt=1,
                               is_ref=False)

    def _download_core(self, core) -> dict:
        return {k: core[k].cpu().numpy() for k in CORE_FIELDS}

    def _commit_p(self, core, frame, forced, qp, qpc, plan) -> PictureCommit:
        return PictureCommit(core, frame, qp, qpc, forced, plan, rd=self.rd)

    def _deblock_p(self, c: PictureCommit):
        """The committed picture's boundary strengths, deblock (unless the
        loop filter is off) and reference prep on the device; returns the
        deblocked planes and the reference state."""
        dec = self._loop_filter(c.rec, c.pic)
        return dec, E.prep_ref(*dec)

    def _errdo_update(self, pic: PictureData, rec_y) -> None:
        """Advance rdo 3's simulated lossy decoders past the anchor that
        ships (pic, its deblocked luma on the device), once per anchor
        (jm_tpu encoder.py:1378)."""
        if self.errdo is not None:
            self.errdo.update(pic, rec_y.cpu().numpy(), self.mb_w,
                              is_ref=True)

    def _serialize_p(self, pic: PictureData, disp: int, qp: int, plan,
                     sizes=None, sp: bool = False, **hdr):
        """A P (with sp an SP) picture's slices serialized on the host
        (hdr: the marking and list-modification keywords of its slice
        headers): (their NAL units, what ``results`` records of them)."""
        return self._picture_nals(pic, SliceType.SP if sp else SliceType.P,
                                  2 * (disp - self._idr_disp), qp, plan,
                                  sizes, **hdr)

    # ---- host serializers ----------------------------------------------

    def _picture_nals(self, pic: PictureData, slice_type: SliceType,
                      poc: int, qp: int, plan, sizes=None, idr=None,
                      nal_ref_idc: int = 3, **hdr):
        """The picture as one NAL unit per slice of plan (IDR units for an
        IDR picture; idr None: every I picture is one), CAVLC or CABAC,
        hdr the slice headers' marking and list keywords; with CABAC
        followed by the cabac_zero_words its bin count calls for. With
        data_partition a CAVLC P slice is partitions A, B and C (NAL units
        2-4, an empty partition left out). The size of each slice without
        its first start code is appended to sizes. Returns (bytes,
        {"cabac_init_idc": [each slice's]} for a CABAC P or B picture,
        else {})."""
        if idr is None:
            idr = slice_type == SliceType.I
        kw = dict(slice_type=slice_type, frame_num=self.frame_num, idr=idr,
                  qp=qp, poc_lsb=poc % 256, idr_pic_id=self.idr_pic_id,
                  **hdr)
        p_like = slice_type in (SliceType.P, SliceType.SP)
        if p_like:
            kw["num_ref_idx_l0"] = self.num_ref_active
        nal_type = NalUnitType.IDR if idr else NalUnitType.SLICE
        cabac = self.cfg.entropy == "cabac"
        if slice_type == SliceType.SP and not cabac:
            # jm_tpu's CABAC writer leaves QS out of an SP slice header
            # (its serialize_slice_cabac, syntax_cabac.py:752-767), which
            # then says 0
            kw["qs"] = self.cfg.qp_sp2
        dp = self.cfg.data_partition and p_like and not cabac
        out, bins, idcs = b"", 0, []
        for sid, addrs in enumerate(plan):
            if dp:
                parts = serialize_slice_dp(
                    pic, self.sps, self.pps, slice_id=sid, mb_addrs=addrs,
                    slice_group_change_cycle=self.cfg.sg_change_cycle, **kw)
                unit = b"".join(
                    annexb_bytes(3, t, rbsp) for t, rbsp in zip(
                        (NalUnitType.DPA, NalUnitType.DPB, NalUnitType.DPC),
                        parts) if rbsp)
                if sizes is not None:
                    sizes.append(len(unit) - 4)
                out += unit
                continue
            if cabac:
                rbsp, b, idc = self._serialize_cabac_best_init(
                    pic, mb_addrs=addrs, **kw)
                bins += b
                idcs.append(idc)
            else:
                rbsp = serialize_slice(
                    pic, self.sps, self.pps, mb_addrs=addrs,
                    slice_group_change_cycle=self.cfg.sg_change_cycle, **kw)
            unit = annexb_bytes(nal_ref_idc, nal_type, rbsp)
            if sizes is not None:
                sizes.append(len(unit) - 4)
            out += unit
        if not cabac:
            return out, {}
        out += self._cabac_zero_words(out, bins, len(plan))
        return out, ({} if slice_type == SliceType.I
                     else {"cabac_init_idc": idcs})

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

    def _cabac_zero_words(self, vcl: bytes, bins: int, n_units: int) -> bytes:
        """Clause 7.4.2.10: cabac_zero_words (EBSP 00 00 03) after the
        picture's last slice NAL unit when the bins coded in the picture
        exceed what its size allows (lencod/src/nal.c addCabacZeroWords;
        jm_tpu encoder.py _cabac_zero_words). RawMbBits of 8-bit video is
        256 * 8 luma bits and 2 * 8 * ch * 8 chroma bits (3072 at 4:2:0,
        4096 at 4:2:2); vcl holds the picture's n_units slice NAL
        units."""
        n_mbs = self.mb_w * self.mb_h
        raw_mb_bits = 256 * 8 + 2 * 8 * 8 * self.cfg.chroma_format * 8
        min_bytes = (96 * bins - raw_mb_bits * n_mbs * 3 + 1023) // 1024
        vcl_bytes = len(vcl) - 3 * n_units   # NAL header + EBSP, as JM
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


# results' names of the intra MB classes
_INTRA_CLASSES = (("i4", MB_I4), ("i16", MB_I16), ("ipcm", MB_IPCM))


def _qp_unsent(pic: PictureData, plan, slice_qp: int) -> int:
    """The MBs of a picture coded in basic units whose pic.qp is not the
    QP a decoder derives for them: MBs that send no mb_qp_delta (P_Skip,
    and inter or I_NxN MBs without coefficients) take the QP of the MB
    before them in the slice (spec 7.4.5), while jm_tpu, and the port
    after it, deblock them with their unit's QP (ROADMAP Queue 3)."""
    n = 0
    for addrs in plan:
        qp = slice_qp
        for a in addrs:
            if not pic.skip[a] and (pic.cbp[a] or pic.mb_class[a] == MB_I16):
                qp = int(pic.qp[a])
            elif int(pic.qp[a]) != qp:
                n += 1
    return n


def _motion(pic: PictureData) -> tuple:
    """The motion a coded picture leaves for the direct prediction of
    later B pictures (the decoder's Frame.motion)."""
    return (pic.mv, pic.ref_idx, pic.mv_l1, pic.ref_idx_l1, pic.ref_pic_id,
            pic.ref_pic_id_l1)


class _Trials:
    """The codings of one anchor among which rd_picture_decision and
    wp_mcprec choose (jm_tpu _emit_anchor :1281-1345): ``qps``, the QPs
    to code it at (qp, qp - 1 and qp + 1, clamped to 0..51, after the
    first picture without rate control, else qp alone), and extra
    codings at qp (wp_mcprec's tables). add() takes each coding's slice
    NAL units, its deblocked planes on the device and what the caller
    keeps of it; best() the coding of least frame J = SSD of the
    deblocked Y + U + V against the source planes + lambda_mode(qp) 8
    bytes (the first on a tie), as (its QP, NAL units, deblocked planes,
    the kept tuple); info() results' record of the codings, when there
    are several: each one's QP, bytes, J and wall ms."""

    def __init__(self, enc: Encoder, planes, qp: int, extra: int = 0):
        self.planes, self.qp = planes, qp
        self.qps = [qp]
        if enc.cfg.rd_picture_decision and enc.frame_idx > 0 \
                and enc.rc is None:
            self.qps = [qp, max(0, qp - 1), min(51, qp + 1)]
        self.several = len(self.qps) + extra > 1
        self.rows, self._best, self._t0 = [], None, 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def add(self, q: int, nal: bytes, dec, *keep) -> None:
        j = 0.0
        if self.several:
            ssd = sum(int(((s.to(torch.int64) - d.to(torch.int64)) ** 2)
                          .sum()) for s, d in zip(self.planes, dec))
            j = float(ssd) + lambda_mode(self.qp) * 8 * len(nal)
            self.rows.append({"qp": q, "bytes": len(nal), "j": j,
                              "ms": (time.perf_counter() - self._t0) * 1e3})
        if self._best is None or j < self._best[0]:
            self._best = (j, q, nal, dec, keep)

    def best(self):
        return self._best[1:]

    def info(self) -> dict:
        return {"trials": self.rows} if self.rows else {}


class _Coded:
    """A picture coded on the device: its PictureData and (Y, U, V)
    undeblocked recon planes, device tensors."""

    def __init__(self, pic: PictureData, rec):
        self.pic, self.rec = pic, rec


class _BasicUnits:
    """The basic units of rate control in one coding of a P picture (the
    host P coder's ``units``; jm_tpu _FrameEncoder.encode :2179-2203): a
    ratectl.BasicUnitRC from the picture's QP and rate control's target
    bits, each MB's QP with its chroma QP and lambdas, and each coded
    MB's bits counted by rdo.count_mb_bits (arithmetic-coded bits in a
    CABAC picture whose RD tools installed a running engine, as in
    jm_tpu)."""

    def __init__(self, enc: Encoder, qp: int):
        self.rc = BasicUnitRC(qp, enc.rc.target, enc.mb_w * enc.mb_h,
                              enc.cfg.rc_basic_unit)
        self.sps, self.pps = enc.sps, enc.pps
        self.num_ref = enc.num_ref_active

    def params(self):
        q = self.rc.mb_qp()
        return (q, chroma_qp(q, self.pps.chroma_qp_index_offset),
                lambda_me(q), lambda_mode4(q))

    def report(self, coder, addr: int) -> None:
        """Report MB addr of the host P coder `coder` (at its running QP;
        counted by its slice's CABAC engine where one is installed)."""
        self.rc.report(count_mb_bits(coder.pic, self.sps, self.pps,
                                     coder.qp, addr, SliceType.P,
                                     self.num_ref, coder.cabac_rate))
