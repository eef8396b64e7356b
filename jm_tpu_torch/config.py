"""JM-compatible configuration: encoder/decoder `.cfg` files + `-p` overrides;
the port's own copy of jm_tpu/config.py, whose ``to_encoder_config``
returns the port's EncoderConfig on jm_tpu's host pipeline.

Parity with lcommon/src/config_common.c (ParseContent tokenizer: whitespace
tokens, `name = value` triples, `#` comments to end of line, double-quoted
strings; unrecognized parameter names warn and are skipped — JM 19 prints
and continues, config_common.c:214-219) and the declarative Mapping tables
of lencod/inc/configfile.h:26 (516 params) / ldecod/inc/configfile.h:30.

Precedence mirrors the reference CLI (Readme.txt:100): defaults, then
`-d file`, then `-f file`s in order, then `-p Name=Value` overrides.

The FULL legal parameter inventory is enforced against the machine-extracted
schema in `common/config_map.py` (names case-insensitive like JM's
ParameterNameToMapIndex; limits per TestParams, config_common.c:320). Every
parameter is classified: *mapped* (applied to the encoder), *neutral*
(reporting/speed knobs with no bitstream semantics, accepted), or
*unsupported* — which raises `UnsupportedParamError` when set to a value
other than the JM default. There are zero silent ignores: a config either
runs with JM semantics or fails naming the exact parameters it cannot honor.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field

from .common.config_map import ENCODER_PARAMS, DECODER_PARAMS

_ENC_BY_LOWER = {k.lower(): k for k in ENCODER_PARAMS}
_DEC_BY_LOWER = {k.lower(): k for k in DECODER_PARAMS}


class UnsupportedParamError(NotImplementedError):
    """A legal JM parameter was set to a value the encoder does not
    implement."""


# WP estimation sub-parameters the reference only reads once explicit WP is
# on (wp.c/wp_lms.c dispatch behind active_pps weighted flags)
_WP_SUBPARAMS = frozenset({
    "ChromaWeightSupport", "UseWeightedReferenceME", "WPMethod", "WPIterMC",
    "WPMCPrecision", "WPMCPrecFullRef", "WPMCPrecBSlice",
    "EnhancedBWeightSupport"})


def _coerce(name: str, val: str, typ: int):
    try:
        if typ == 0:
            return int(float(val))
        if typ == 2:
            return float(val)
    except ValueError:
        raise ValueError(
            f"Parsing error: expected numerical value for {name}, "
            f"found '{val}'") from None
    return val.strip('"')


def _check_limits(name: str, v, schema) -> None:
    """TestParams' range checks (config_common.c:320): limit kinds
    0 none, 1 min&max, 2 min-only, 3 QP-range (0..51 at 8-bit)."""
    typ, _dflt, lim, lo, hi = schema
    if typ == 1:
        return
    if lim == 1 and not (lo <= v <= hi):
        raise ValueError(f"Error in input parameter {name}. Check configuration"
                         f" file. Value should be in [{lo}, {hi}].")
    if lim == 2 and v < lo:
        raise ValueError(f"Error in input parameter {name}. Check configuration"
                         f" file. Value should be at least {lo}.")
    if lim == 3 and not (0 <= v <= 51):
        raise ValueError(f"Error in input parameter {name}. Check configuration"
                         f" file. Value should be in [0, 51].")


def tokenize_cfg(text: str) -> list[str]:
    """ParseContent stage one: comments stripped, quoted strings kept whole."""
    out = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0]
        for tok in re.findall(r'"[^"]*"|\S+', line):
            # '=' may be glued to names/values in JM files
            if tok != "=" and "=" in tok and not tok.startswith('"'):
                for part in re.split(r"(=)", tok):
                    if part:
                        out.append(part)
            else:
                out.append(tok)
    return out


def parse_cfg_text(text: str) -> dict[str, str]:
    toks = tokenize_cfg(text)
    kv: dict[str, str] = {}
    i = 0
    while i + 2 < len(toks) or (i + 2 == len(toks) and len(toks) >= 3):
        if i + 2 >= len(toks):
            break
        name, eq, val = toks[i], toks[i + 1], toks[i + 2]
        if eq != "=":
            raise ValueError(f"config parse error near '{name}': expected '='")
        kv[name] = val.strip('"')
        i += 3
    return kv


@dataclass
class EncoderParams:
    """Typed view of the JM encoder parameters the framework implements,
    plus IO. Field names follow the reference cfg names (configfile.h)."""
    InputFile: str = ""
    OutputFile: str = "test.264"
    ReconFile: str = ""
    StatsFile: str = "stats.dat"
    SourceWidth: int = 176
    SourceHeight: int = 144
    FrameRate: float = 30.0
    FramesToBeEncoded: int = 1
    StartFrame: int = 0
    QPISlice: int = 28
    QPPSlice: int = 28
    QPBSlice: int = 30
    IntraPeriod: int = 0
    NumberReferenceFrames: int = 1
    SearchRange: int = 16
    SearchMode: int = 0          # -1 FS, 0 fast-full, 1/2 UMHex, 3 EPZS
    HMEEnable: int = 0           # hierarchical pyramid ME (me_hme.c)
    InterSearch8x4: int = 0
    InterSearch4x8: int = 0
    InterSearch4x4: int = 0
    SymbolMode: int = 0          # 0 CAVLC, 1 CABAC
    ContextInitMethod: int = 0   # 0 fixed model 0, 1 adaptive (3 models)
    UseRDOQuant: int = 0         # trellis quantization (rdoq.c)
    RDOQ_DC: int = 0
    RDOQ_CR: int = 0
    RDOQ_DC_CR: int = 0
    RDOQ_QP_Num: int = 1
    ProfileIDC: int = 66
    LevelIDC: int = 30
    NumberBFrames: int = 0
    HierarchicalCoding: int = 0
    NumberOfViews: int = 1
    View1ConfigFile: str = ""
    SepViewInterSearch: int = 0
    ExplicitHierarchyFormat: str = ""
    LongTermPeriod: int = 0
    Transform8x8Mode: int = 0
    YUVFormat: int = 1
    # custom quantization (q_matrix.c / q_offsets.c / q_around.c)
    QmatrixFile: str = ""
    ScalingMatrixPresentFlag: int = 0
    ScalingListPresentFlag0: int = 0
    ScalingListPresentFlag1: int = 0
    ScalingListPresentFlag2: int = 0
    ScalingListPresentFlag3: int = 0
    ScalingListPresentFlag4: int = 0
    ScalingListPresentFlag5: int = 0
    ScalingListPresentFlag6: int = 0
    ScalingListPresentFlag7: int = 0
    OffsetMatrixPresentFlag: int = 0
    QOffsetMatrixFile: str = ""
    AdaptiveRounding: int = 0
    AdaptRndPeriod: int = 16
    AdaptRndWFactorIRef: int = 4
    AdaptRndWFactorPRef: int = 4
    AdaptRndWFactorBRef: int = 4
    RDOptimization: int = 0
    EnableIPCM: int = 0
    NumberOfDecoders: int = 0
    LossRateA: int = 0
    RDPictureDecision: int = 0
    DisableLoopFilter: int = 0   # via LoopFilterDisable
    RateControlEnable: int = 0
    Bitrate: int = 45020
    InitialQP: int = 0
    BasicUnit: int = 0           # MBs per within-frame RC unit
    DistortionSSIM: int = 0
    DistortionMSSSIM: int = 0
    SSIMOverlapSize: int = 8
    OutFileMode: int = 0         # 0 Annex-B, 1 RTP dump (lencod rtp.c)
    RandomIntraMBRefresh: int = 0
    WeightedPrediction: int = 0
    WeightedBiprediction: int = 0
    EnableVUISupport: int = 0
    NumberLeakyBuckets: int = 0
    LeakyBucketParamFile: str = "leakybucketparam.cfg"
    SliceMode: int = 0
    SliceArgument: int = 0
    num_slice_groups_minus1: int = 0
    slice_group_map_type: int = 0
    slice_group_change_direction_flag: int = 0
    slice_group_change_rate_minus1: int = 0
    SliceGroupConfigFileName: str = ""
    LeakyBucketRateFile: str = ""
    ReferenceReorder: int = 0
    PocMemoryManagement: int = 0
    SPPicturePeriodicity: int = 0
    PartitionMode: int = 0
    QPSPSlice: int = 24
    QPSP2Slice: int = 0
    RCMinQP: int = 8             # RCMinQPPSlice (rate_control.c clamps)
    RCMaxQP: int = 42            # RCMaxQPPSlice
    SEIMessageText: str = ""
    ignored: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)  # legal JM params, unmapped

    _INT_FIELDS = {
        "SourceWidth", "SourceHeight", "FramesToBeEncoded", "StartFrame",
        "QPISlice", "QPPSlice", "QPBSlice", "IntraPeriod",
        "NumberReferenceFrames",
        "SearchRange", "SearchMode", "HMEEnable",
        "SymbolMode", "ContextInitMethod", "UseRDOQuant",
        "RDOQ_DC", "RDOQ_CR", "RDOQ_DC_CR",
        "RDOQ_QP_Num", "ProfileIDC", "LevelIDC",
        "InterSearch8x4", "InterSearch4x8", "InterSearch4x4",
        "NumberBFrames", "HierarchicalCoding", "LongTermPeriod", "Transform8x8Mode",
        "NumberOfViews", "SepViewInterSearch",
        "RDOptimization", "EnableIPCM", "RDPictureDecision", "YUVFormat",
        "ScalingMatrixPresentFlag", "ScalingListPresentFlag0",
        "ScalingListPresentFlag1", "ScalingListPresentFlag2",
        "ScalingListPresentFlag3", "ScalingListPresentFlag4",
        "ScalingListPresentFlag5", "ScalingListPresentFlag6",
        "ScalingListPresentFlag7", "OffsetMatrixPresentFlag",
        "AdaptiveRounding", "AdaptRndPeriod", "AdaptRndWFactorIRef",
        "AdaptRndWFactorPRef", "AdaptRndWFactorBRef",
        "NumberOfDecoders", "LossRateA", "RateControlEnable",
        "Bitrate", "InitialQP", "BasicUnit", "DistortionSSIM",
        "DistortionMSSSIM", "SSIMOverlapSize", "OutFileMode",
        "SliceMode", "SliceArgument", "num_slice_groups_minus1",
        "RandomIntraMBRefresh", "WeightedPrediction", "WeightedBiprediction",
        "EnableVUISupport", "NumberLeakyBuckets",
        "slice_group_map_type", "slice_group_change_direction_flag",
        "slice_group_change_rate_minus1", "RCMinQP", "RCMaxQP",
        "ReferenceReorder", "PocMemoryManagement",
        "SPPicturePeriodicity", "QPSPSlice", "QPSP2Slice",
        "PartitionMode",
    }
    _STR_FIELDS = {"InputFile", "OutputFile", "ReconFile", "StatsFile",
                   "SliceGroupConfigFileName", "LeakyBucketParamFile",
                   "LeakyBucketRateFile", "SEIMessageText",
                   "ExplicitHierarchyFormat", "QmatrixFile",
                   "QOffsetMatrixFile", "View1ConfigFile"}
    _ALIASES = {
        "DistortionMS_SSIM": "DistortionMSSSIM",   # reference cfg name
        "LoopFilterDisable": "DisableLoopFilter",
        "OutputWidth": "SourceWidth",       # no resize support: must match
        "OutputHeight": "SourceHeight",
        "NumberofLeakyBuckets": "NumberLeakyBuckets",
        "RCMinQPPSlice": "RCMinQP", "RCMaxQPPSlice": "RCMaxQP",
    }

    # Legal JM parameters that only steer encoder-side heuristics or
    # reporting (never bitstream syntax): accepted at any value, recorded in
    # `.ignored` and reported once — not silent, and never raise.
    _TOLERATED_PREFIXES = ("EPZS", "UMHex", "MEDistortion", "Report",
                          "Display", "LambdaWeight", "AdaptRndCr")
    _TOLERATED = {
        "Verbose", "SummaryFile", "LogFile", "StatsFileMode",
        "ProcessInput", "ChromaMCBuffer", "ChromaMEEnable",
        "ChromaMEWeight", "BiPredMotionEstimation", "BiPredMERefinements",
        "BiPredMESearchRange", "BiPredSearch16x16", "BiPredSearch16x8",
        "BiPredSearch8x16", "BiPredSearch8x8", "PrefetchRef",
        "SetFirstAsLongTerm", "SearchRange8x8", "TraceFile",
        "SubMBCodingState", "FastCrIntraDecision", "I16RDOpt",
        "BiasSkipRDO", "DisableThresholding", "SetMVXLimit", "SetMVYLimit",
        "BiPredMESubPel", "AdaptRndChroma", "RDOQ_CP_Mode",
        "RDOQ_CP_MV", "RDOQ_Fast", "AdaptRoundingFixed",
        "AdaptRndWFactorINRef", "AdaptRndWFactorPNRef",
        "AdaptRndWFactorBNRef",
    }

    # extra-schema parameters that ARE implemented (consumed from
    # `.extra` by their feature sites rather than mapped to
    # EncoderConfig fields): explicit sequence scripting
    # (tools/lencod.py -> encoder/gop.py) and the packed-source readers
    # (tools/input.py)
    _IMPLEMENTED_EXTRA = frozenset({
        "ExplicitSeqCoding", "ExplicitSeqFile",
        "Interleaved", "PixelFormat",
    })

    # Sub-parameters that are inert unless their master feature switch is
    # active, mirroring how the reference only *reads* them behind the flag
    # (e.g. rc QP clamps behind RateControlEnable, rate_control.c). A pending
    # non-default value only faults the config when the gate fires.
    _GATES = {
        "RateControlEnable": (
            "RCMinQPBSlice", "RCMaxQPBSlice",
            "RCMinQPISlice", "RCMaxQPISlice", "RCMinQPSPSlice",
            "RCMaxQPSPSlice", "RCMinQPSISlice", "RCMaxQPSISlice",
            "RCUpdateMode"),
        "AdaptiveRounding": (
            "AdaptRoundingFixed", "AdaptRndChroma",
            "AdaptRndWFactorINRef", "AdaptRndWFactorPNRef",
            "AdaptRndWFactorBNRef", "AdaptRndCrWFactorIRef",
            "AdaptRndCrWFactorPRef", "AdaptRndCrWFactorBRef",
            "AdaptRndCrWFactorINRef", "AdaptRndCrWFactorPNRef",
            "AdaptRndCrWFactorBNRef"),
        "SparePictureOption": (
            "SparePictureDetectionThr", "SparePicturePercentageThr"),
        "UseRedundantPicture": (
            "NumRedundantHierarchy", "PrimaryGOPLength", "NumRefPrimary"),
        "SPPicturePeriodicity": (
            "QPSISlice", "SI_FRAMES", "SP2_FRAMES",
            "SP_output_indicator", "SP_output_name", "SP2_input_name1",
            "SP2_input_name2", "LambdaWeightSPSlice", "LambdaWeightSISlice"),
        "ToneMappingSEIPresentFlag": ("ToneMappingFile",),
        "ExplicitSeqCoding": ("ExplicitSeqFile",),
        "IntraPeriod": ("AdaptiveIntraPeriod",),
        "IDRPeriod": ("AdaptiveIDRPeriod",),
        "EnableVUISupport": (
            "VUI_aspect_ratio_info_present_flag", "VUI_aspect_ratio_idc",
            "VUI_sar_width", "VUI_sar_height",
            "VUI_overscan_info_present_flag", "VUI_overscan_appropriate_flag",
            "VUI_video_signal_type_present_flag", "VUI_video_format",
            "VUI_video_full_range_flag",
            "VUI_colour_description_present_flag", "VUI_colour_primaries",
            "VUI_transfer_characteristics", "VUI_matrix_coefficients",
            "VUI_chroma_location_info_present_flag",
            "VUI_chroma_sample_loc_type_top_field",
            "VUI_chroma_sample_loc_type_bottom_field",
            "VUI_timing_info_present_flag", "VUI_num_units_in_tick",
            "VUI_time_scale", "VUI_fixed_frame_rate_flag",
            "VUI_nal_hrd_parameters_present_flag", "VUI_nal_cpb_size_scale",
            "VUI_nal_bit_rate_value_minus1", "VUI_nal_cpb_size_value_minus1",
            "VUI_nal_vbr_cbr_flag", "VUI_nal_initial_cpb_removal_delay_length",
            "VUI_nal_cpb_removal_delay_length",
            "VUI_nal_dpb_output_delay_length", "VUI_nal_time_offset_length",
            "VUI_vcl_hrd_parameters_present_flag", "VUI_vcl_cpb_size_scale",
            "VUI_vcl_bit_rate_value_minus1", "VUI_vcl_cpb_size_value_minus1",
            "VUI_vcl_vbr_cbr_flag", "VUI_vcl_initial_cpb_removal_delay_length",
            "VUI_vcl_cpb_removal_delay_length",
            "VUI_vcl_dpb_output_delay_length", "VUI_vcl_time_offset_length",
            "VUI_low_delay_hrd_flag", "VUI_pic_struct_present_flag",
            "VUI_bitstream_restriction_flag",
            "VUI_motion_vectors_over_pic_boundaries_flag",
            "VUI_max_bytes_per_pic_denom", "VUI_max_bits_per_mb_denom",
            "VUI_log2_max_mv_length_vertical",
            "VUI_log2_max_mv_length_horizontal",
            "VUI_num_reorder_frames", "VUI_max_dec_frame_buffering"),
    }
    _GATE_OF = {p: m for m, ps in _GATES.items() for p in ps}

    # Parameter=value pairs that are equivalent to what the encoder does
    # (so the setting is supported, not merely tolerated).
    _EQUIVALENT = {
        "Log2MaxPOCLsbMinus4": {-1},   # -1 = auto-derive, our behavior
        "DirectModeType": {1},         # encoder B direct is spatial
        "PicInterlace": {0}, "MbInterlace": {0},
        # stereo: our MVC coder already places the inter-view ref first via
        # a reorder command (encoder.py view-1 list build)
        "MVCInterViewReorder": {1},
        # dyadic hierarchy already bumps QP by +1 per temporal layer
        # (encoder.py B-picture QP assignment)
        "HierarchyLevelQPEnable": {1},
    }

    def apply(self, kv: dict[str, str]) -> None:
        for name, val in kv.items():
            canon = _ENC_BY_LOWER.get(name.lower(), name)
            tgt = self._ALIASES.get(canon, canon)
            if tgt in self._INT_FIELDS or tgt == "DisableLoopFilter":
                v = int(float(val))
                if canon in ENCODER_PARAMS:
                    _check_limits(canon, v, ENCODER_PARAMS[canon])
                setattr(self, tgt, v)
            elif tgt in self._STR_FIELDS:
                setattr(self, tgt, val.strip('"'))
            elif tgt == "FrameRate":
                self.FrameRate = float(val)
            elif canon in ENCODER_PARAMS:
                schema = ENCODER_PARAMS[canon]
                v = _coerce(canon, val, schema[0])
                _check_limits(canon, v, schema)
                self.extra[canon] = v
                self.ignored[canon] = val
            else:
                # JM 19: unrecognized names warn and continue
                # (config_common.c:214-219)
                print(f"\tParsing error in config file: Parameter Name "
                      f"'{name}' not recognized.", file=sys.stderr)
                self.ignored[name] = val

    def _master_active(self, master: str) -> bool:
        if hasattr(self, master):
            return bool(getattr(self, master))
        dflt = ENCODER_PARAMS.get(master, (0, 0))[1]
        return bool(self.extra.get(master, dflt))

    def check_unmapped(self) -> None:
        """Fail fast, naming every legal-but-unimplemented parameter that is
        set to a non-default value AND whose master feature gate is active.
        Zero silent ignores: everything else set lands in `.ignored`."""
        unsupported = []
        for canon, v in self.extra.items():
            if canon in self._IMPLEMENTED_EXTRA:
                continue      # consumed by tools/encoder (see each site)
            if (canon in self._TOLERATED
                    or canon.startswith(self._TOLERATED_PREFIXES)):
                continue
            typ, dflt = ENCODER_PARAMS[canon][:2]
            if (v == "" if typ == 1 else v == dflt):
                continue
            if v in self._EQUIVALENT.get(canon, ()):
                continue
            master = self._GATE_OF.get(canon)
            if master and not self._master_active(master):
                continue
            if canon in _WP_SUBPARAMS and not (
                    self.WeightedPrediction or self.WeightedBiprediction):
                continue
            if canon == "ResendSPS" and self.IntraPeriod == 0 \
                    and not self.extra.get("IDRPeriod"):
                continue  # a single IDR: nothing is ever resent
            if canon in ("BRefPicQPOffset", "HierarchyLevelQPEnable") \
                    and not (self.HierarchicalCoding
                             or self.extra.get("BReferencePictures")):
                continue  # no referenced B pictures exist
            if canon == "BRefPicQPOffset" \
                    and self.extra.get("HierarchyLevelQPEnable") == 1:
                continue  # per-level QP overrides the flat B-ref offset
            if canon.startswith("ScalingListPresentFlag") \
                    and canon[len("ScalingListPresentFlag"):].isdigit() \
                    and int(canon[len("ScalingListPresentFlag"):]) >= 8 \
                    and self.YUVFormat != 3:
                continue  # lists 8-11 exist only for 4:4:4 (q_matrix.c)
            unsupported.append(f"{canon}={v!r} (only the JM default "
                               f"{dflt!r} is supported)")
        if unsupported:
            raise UnsupportedParamError(
                "config requests unimplemented JM features: "
                + "; ".join(unsupported))

    def validate(self) -> None:
        unsupported = []
        if self.Transform8x8Mode not in (0, 1):
            unsupported.append(f"Transform8x8Mode {self.Transform8x8Mode}")
        if self.ProfileIDC not in (66, 77, 88, 100, 122, 118, 128):
            unsupported.append(f"ProfileIDC {self.ProfileIDC}")
        if self.SymbolMode not in (0, 1):
            unsupported.append(f"SymbolMode {self.SymbolMode}")
        if self.ReferenceReorder == 2:
            unsupported.append("ReferenceReorder 2 (temporal-layer)")
        if self.ReferenceReorder == 1 and self.extra.get("UseDistortionReorder"):
            unsupported.append("UseDistortionReorder 1 (MSE-based reorder)")
        if self.PocMemoryManagement == 2:
            unsupported.append("PocMemoryManagement 2 (temporal-layer)")
        if unsupported:
            raise NotImplementedError("; ".join(unsupported))
        self.check_unmapped()

    def _read_sg_config(self):
        """SliceGroupConfigFileName contents for map types 0/2/6 (the
        reference's read_slice_group_info, lencod/src/configfile.c:2049):
        bare integers, one per line, comments after values allowed."""
        vals = []
        with open(self.SliceGroupConfigFileName, encoding="latin-1") as fh:
            for line in fh:
                tok = line.split("#")[0].strip().split()
                if tok and tok[0].lstrip("-").isdigit():
                    vals.append(int(tok[0]))
        return vals

    def to_encoder_config(self):
        """The port's EncoderConfig of these parameters, equal to
        jm_tpu's field by field: pipeline "host" and device_rd False,
        the defaults of jm_tpu's EncoderConfig, which jm_tpu's config
        layer leaves unset (the port's defaults are its device route with
        the RD P path), so that a cfg file gives jm_tpu's bytes."""
        from .encoder.encoder import EncoderConfig
        sg = {}
        if self.num_slice_groups_minus1 > 0:
            t = self.slice_group_map_type
            sg = dict(num_slice_groups=self.num_slice_groups_minus1 + 1,
                      slice_group_map_type=t,
                      sg_change_direction=self.slice_group_change_direction_flag,
                      sg_change_rate_minus1=self.slice_group_change_rate_minus1)
            if t in (0, 2, 6) and self.SliceGroupConfigFileName:
                v = self._read_sg_config()
                if t == 0:
                    sg["sg_run_length"] = tuple(
                        x + 1 for x in v[:self.num_slice_groups_minus1 + 1])
                elif t == 2:
                    sg["sg_top_left"] = tuple(v[0::2])
                    sg["sg_bottom_right"] = tuple(v[1::2])
                else:
                    sg["sg_ids"] = tuple(v)
        qm = {}
        if self.ScalingMatrixPresentFlag and self.QmatrixFile:
            from .encoder.qmatrix import parse_matrix_cfg
            with open(self.QmatrixFile, encoding="latin-1") as fh:
                l4, l8 = parse_matrix_cfg(fh.read())
            qm["scaling_matrix"] = self.ScalingMatrixPresentFlag
            qm["scaling_lists4"] = tuple(tuple(x) for x in l4)
            qm["scaling_lists8"] = tuple(tuple(x) for x in l8)
            qm["scaling_present"] = tuple(
                getattr(self, f"ScalingListPresentFlag{i}") for i in range(8))
        if self.OffsetMatrixPresentFlag and self.QOffsetMatrixFile:
            from .encoder.qmatrix import parse_offset_cfg
            with open(self.QOffsetMatrixFile, encoding="latin-1") as fh:
                o4, o8 = parse_offset_cfg(fh.read())
            qm["offset_matrix"] = (o4, o8)
        if self.AdaptiveRounding:
            qm["adaptive_rounding"] = True
            qm["adapt_rnd_period"] = self.AdaptRndPeriod
            qm["adapt_rnd_w"] = self.AdaptRndWFactorPRef
        return EncoderConfig(
            slice_mode=self.SliceMode, slice_argument=self.SliceArgument,
            **qm,
            intra_mb_refresh=self.RandomIntraMBRefresh,
            weighted_pred=self.WeightedPrediction,
            wp_method=self.extra.get("WPMethod", 0),
            wp_iter_mc=self.extra.get("WPIterMC", 0),
            wp_mcprec=self.extra.get("WPMCPrecision", 0),
            weighted_bipred=self.WeightedBiprediction,
            enable_vui=bool(self.EnableVUISupport),
            sub8x8=bool(self.InterSearch8x4 or self.InterSearch4x8
                        or self.InterSearch4x4),
            **sg,
            width=self.SourceWidth, height=self.SourceHeight,
            qp=self.QPISlice, intra_period=self.IntraPeriod,
            search_range=self.SearchRange,
            search_mode=self.SearchMode, hme=bool(self.HMEEnable),
            num_ref=self.NumberReferenceFrames,
            level_idc=self.LevelIDC,
            deblock=not self.DisableLoopFilter,
            entropy="cabac" if self.SymbolMode else "cavlc",
            cabac_adapt_init=bool(self.ContextInitMethod),
            rdoq=1 if self.UseRDOQuant else 0,
            rdoq_dc=self.RDOQ_DC, rdoq_cr=self.RDOQ_CR,
            rdoq_dc_cr=self.RDOQ_DC_CR,
            num_b=self.NumberBFrames, qp_b=self.QPBSlice,
            poc_type=self.extra.get("PicOrderCntType", 0),
            hierarchical=1 if self.HierarchicalCoding else 0,
            long_term_period=self.LongTermPeriod,
            explicit_gop=self.ExplicitHierarchyFormat
            if self.HierarchicalCoding == 3 else "",
            transform8x8=bool(self.Transform8x8Mode),
            chroma_format=self.YUVFormat if self.YUVFormat in (1, 2) else 1,
            rdo=self.RDOptimization,     # 0 low, 1 high, 2 highfast,
                                         # 3 highloss, 4 high_updated
                                         # (rdopt.c:242 dispatch)
            num_decoders=self.NumberOfDecoders if self.RDOptimization == 3 else 0,
            loss_rate_a=self.LossRateA if self.RDOptimization == 3 else 0,
            enable_ipcm=self.EnableIPCM,
            rd_picture_decision=bool(self.RDPictureDecision),
            rc_enable=bool(self.RateControlEnable),
            rc_bitrate=self.Bitrate, frame_rate=self.FrameRate,
            rc_initial_qp=self.InitialQP,
            rc_basic_unit=self.BasicUnit if self.RateControlEnable else 0,
            ref_reorder=1 if self.ReferenceReorder == 1 else 0,
            sp_periodicity=self.SPPicturePeriodicity,
            data_partition=1 if self.PartitionMode == 1 else 0,
            qp_sp=self.QPSPSlice, qp_sp2=self.QPSP2Slice,
            poc_mem_mgmt=1 if self.PocMemoryManagement == 1 else 0,
            num_views=2 if self.NumberOfViews == 2 else 1,
            pipeline="host", device_rd=False)


@dataclass
class DecoderParams:
    """ldecod/inc/configfile.h parameter set (the implemented subset)."""
    InputFile: str = "test.264"
    OutputFile: str = "test_dec.yuv"
    RefFile: str = ""
    WriteUV: int = 1
    FileFormat: int = 0          # 0 Annex-B, 1 RTP dump (ldecod rtp.c)
    ConcealMode: int = 0         # 0 off, 1 frame copy, 2 motion copy
    ignored: dict = field(default_factory=dict)

    _TOLERATED = {"Silent", "DisplayDecParams", "SEIDecode"}

    def apply(self, kv: dict[str, str]) -> None:
        unsupported: list[str] = []
        for name, val in kv.items():
            canon = _DEC_BY_LOWER.get(name.lower(), name)
            if canon in ("InputFile", "OutputFile", "RefFile"):
                setattr(self, canon, val.strip('"'))
            elif canon in ("WriteUV", "FileFormat", "ConcealMode"):
                setattr(self, canon, int(val))
            elif canon in DECODER_PARAMS:
                schema = DECODER_PARAMS[canon]
                v = _coerce(canon, val, schema[0])
                _check_limits(canon, v, schema)
                if (canon in self._TOLERATED or v == schema[1]
                        or schema[0] == 1):
                    self.ignored[canon] = val
                else:
                    unsupported.append(f"{canon}={val}")
            else:
                print(f"\tParsing error in config file: Parameter Name "
                      f"'{name}' not recognized.", file=sys.stderr)
                self.ignored[name] = val
        if unsupported:
            raise UnsupportedParamError(
                "config requests unimplemented JM features: "
                + "; ".join(unsupported))


def load_params(cls, d_file: str | None = None, f_files: tuple = (),
                p_overrides: tuple = ()):
    """JM CLI precedence: defaults < -d < -f... < -p Name=Value..."""
    params = cls()
    files = ([d_file] if d_file else []) + list(f_files)
    for path in files:
        with open(path, encoding="latin-1") as fh:
            params.apply(parse_cfg_text(fh.read()))
    for ov in p_overrides:
        if "=" not in ov:
            raise ValueError(f"-p expects Name=Value, got '{ov}'")
        k, v = ov.split("=", 1)
        params.apply({k.strip(): v.strip().strip('"')})
    return params
