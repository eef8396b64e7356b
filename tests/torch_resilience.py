"""Shared cases of the port's error-resilience and reference-management
encoder tests: each configuration encoded at 96x80, QP 30, 6 frames of
test_pipe_stream.make_frames, search range 16, by jm_tpu's
Encoder(pipeline="device") and by the port on the CPU, through
``encode_stream`` or through ``encode_frame`` + ``flush``, once per
process; and the checks that hold them equal (the codec is
integer-exact: the tolerance is zero). Every case runs through both
routes: tests/test_torch_resilience.py holds every route that takes the
per-frame path; the routes that stay on the pipe run where jm_tpu's pipe
programs are compiled already (tests/test_torch_encoder.py for device
RD, test_torch_fallback.py for md_low)."""

import numpy as np

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.bitstream.nal import split_annexb
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames

W, H, QP, N = 96, 80, 30, 6
ROUTES = ("stream", "frame")
CASES = {
    "deblock_off": dict(deblock=False),
    "vui_sei": dict(enable_vui=True, sei_user_data=bytes(range(16))),
    "long_term2": dict(long_term_period=2),
    "long_term3_mdlow": dict(long_term_period=3, device_rd=False),
    "poc_mem_mgmt": dict(poc_mem_mgmt=1),
    "reorder_long_term2": dict(ref_reorder=1, long_term_period=2),
    "redundant2": dict(redundant_period=2),
    "redundant2_mdlow": dict(redundant_period=2, device_rd=False),
    "dp": dict(data_partition=1),
    "dp_slices": dict(data_partition=1, slice_mode=1, slice_argument=7),
    "dp_fmo1": dict(data_partition=1, num_slice_groups=2,
                    slice_group_map_type=1),
    "dp_long_term2": dict(data_partition=1, long_term_period=2),
    # intra MBs in P slices: their residual in partition B
    "dp_intra_refresh": dict(data_partition=1, intra_mb_refresh=4),
    # a weighted bi-prediction PPS (Main profile) without B pictures
    "weighted_bipred_no_b": dict(weighted_bipred=1),
    # the host coders' searchers, which the device route ignores
    "search_mode_hme": dict(search_mode=3, hme=True),
}
# jm_tpu's _pipe_ok has no term for redundant_period, poc_mem_mgmt, SEI,
# VUI, weighted_bipred, search_mode or hme: streams with only these stay
# on the pipe
PIPE_NEUTRAL = {"redundant_period", "poc_mem_mgmt", "enable_vui",
                "sei_user_data", "device_rd", "weighted_bipred",
                "search_mode", "hme"}
_RUNS = {}
_DECODED = {}


def on_pipe(cfg: dict) -> bool:
    return set(cfg) <= PIPE_NEUTRAL


def pipe_cases(rd: bool) -> list:
    """The cases whose encode_stream stays on jm_tpu's pipe, of a tier."""
    return [c for c, cfg in CASES.items()
            if on_pipe(cfg) and cfg.get("device_rd", True) == rd]


def check_all(cfg, route) -> None:
    check_payloads(cfg, route)
    check_recon(cfg, route)
    check_decodes(cfg, route)
    check_pipe_and_syntax(cfg, route)


def _encode(make, cfg: dict, route: str):
    """An encoder of cfg (EncoderConfig keywords; make builds it) and its
    payloads through one route (encode_frame's ending with flush's)."""
    kw = dict(width=W, height=H, qp=QP, search_range=16, **cfg)
    enc = make(device_rd=kw.pop("device_rd", True), **kw)
    frames = make_frames(W, H, N)
    if route == "stream":
        return enc, enc.encode_stream(frames)
    return enc, [enc.encode_frame(*f) for f in frames] + [enc.flush()]


def run(cfg: dict, route: str):
    """(port encoder, port payloads, jm_tpu encoder, jm_tpu payloads) of
    the configuration cfg through one route. Off its pipe, jm_tpu's
    encode_stream is its encode_frame frame by frame (the first branch of
    Encoder.encode_stream), so jm_tpu encodes such a configuration once,
    through encode_frame, and both of the port's routes are held against
    those payloads."""
    key = (tuple(sorted(cfg.items())), route)
    if key not in _RUNS:
        jm_route = route if on_pipe(cfg) else "frame"
        jm_key = (key[0], "jm", jm_route)
        if jm_key not in _RUNS:
            _RUNS[jm_key] = _encode(lambda **kw: JaxEncoder(JaxConfig(
                pipeline="device", **kw)), cfg, jm_route)
        jenc, want = _RUNS[jm_key]
        enc, got = _encode(lambda **kw: Encoder(EncoderConfig(**kw),
                                                device="cpu"), cfg, route)
        _RUNS[key] = (enc, got, jenc, want[:len(got)])
    return _RUNS[key]


def check_payloads(cfg, route):
    _enc, got, _jenc, want = run(cfg, route)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"payload {i} differs"


def check_recon(cfg, route):
    enc, _got, jenc, _want = run(cfg, route)
    assert [r["type"] for r in enc.results] == \
        [r["type"] for r in jenc.results]
    for a, b in zip(enc.results, jenc.results):
        for plane in "YUV":
            assert np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane))


def check_decodes(cfg, route):
    """Both decoders decode the stream to the encoder's recon (a stream
    already decoded, the other route's with the same bytes, is not
    decoded again)."""
    enc, got, _jenc, _want = run(cfg, route)
    data = b"".join(got)
    if data not in _DECODED:
        _DECODED[data] = [dec.decode_annexb(data) for dec in (
            H264Decoder(device="cpu"), JaxDecoder())]
    for out in _DECODED[data]:
        assert len(out) == N
        for frame, res in zip(out, enc.results):
            for plane in "YUV":
                assert np.array_equal(getattr(frame, plane),
                                      getattr(res["frame"], plane))


def check_pipe_and_syntax(cfg, route):
    """Both encoders take the pipe alike; the stream carries the syntax
    of its configuration: partitions A and C, and no whole slice, for
    the P pictures of data partitioning, the redundant codings (through
    encode_frame only, as in jm_tpu), the SEI NAL unit, the loop
    filter's control flag."""
    enc, got, jenc, _want = run(cfg, route)
    assert enc._pipe_ok() == jenc._pipe_ok() == on_pipe(cfg)
    units = split_annexb(b"".join(got))
    types = [u.nal_unit_type for u in units]
    if cfg.get("data_partition"):
        assert 1 not in types and 4 in types
        assert types.count(2) == sum(r["slices"] for r in enc.results[1:])
    if cfg.get("redundant_period"):
        redundant = [u for u in units if u.nal_unit_type == 1
                     and u.nal_ref_idc == 0]
        assert len(redundant) == (0 if route == "stream"
                                  else (N - 1) // cfg["redundant_period"])
    assert (6 in types) == ("sei_user_data" in cfg)
    assert enc.pps.deblocking_filter_control_present_flag == \
        (not cfg.get("deblock", True))
