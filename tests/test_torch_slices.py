"""The port's encoder (device="cpu") against jm_tpu's
Encoder(pipeline="device") on the configurations beyond one slice at a
fixed QP: several slices per picture (slice_mode 1 and 2), FMO slice
groups of map types 0, 1, 2, 4 and 6, frame-level rate control (CAVLC,
and CABAC with cabac_adapt_init and slices), qp_p, and POC types 1 and 2
(which stay on the pipe). 96x80, QP 30, 4 frames of
test_pipe_stream.make_frames, search range 16. Per case: the payloads are
byte-identical, the deblocked recon and every picture's QP equal, and the
stream decodes to the recon with the port's H264Decoder(device="cpu")
and with jm_tpu's. The codec is integer-exact: the tolerance is zero.
Each case is encoded once per module (jm_tpu's JAX programs compile once
per shape and tier)."""

import numpy as np
import pytest

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames

W, H, QP, N = 96, 80, 30, 4
# 30 MBs; a type-6 map with every MB's group drawn from a seed
SG_IDS = tuple(np.random.default_rng(3).integers(0, 2, 30).tolist())
CASES = {
    "slice_mode1": dict(slice_mode=1, slice_argument=6),
    "slice_mode2": dict(slice_mode=2, slice_argument=120),
    "fmo_t0": dict(num_slice_groups=3, slice_group_map_type=0,
                   sg_run_length=(4, 2, 6)),
    "fmo_t1": dict(num_slice_groups=2, slice_group_map_type=1),
    "fmo_t2": dict(num_slice_groups=3, slice_group_map_type=2,
                   sg_top_left=(7, 14), sg_bottom_right=(20, 27)),
    "fmo_t4": dict(num_slice_groups=2, slice_group_map_type=4,
                   sg_change_direction=1, sg_change_rate_minus1=3,
                   sg_change_cycle=5),
    "fmo_t6": dict(num_slice_groups=2, slice_group_map_type=6,
                   sg_ids=SG_IDS),
    "fmo_t1_bytes_qpp_poc1_mdlow": dict(
        num_slice_groups=2, slice_group_map_type=1, slice_mode=2,
        slice_argument=120, qp_p=32, poc_type=1, device_rd=False),
    # QPs 25, 25, 29, 30
    "rc": dict(rc_enable=True, rc_bitrate=46000.0),
    # QPs 25, 25, 29, 28
    "cabac_slices_rc": dict(entropy="cabac", cabac_adapt_init=True,
                            slice_mode=1, slice_argument=8, rc_enable=True,
                            rc_bitrate=60000.0),
    "qp_p": dict(qp_p=33),
    "poc1": dict(poc_type=1, device_rd=False),
    "poc2": dict(poc_type=2, device_rd=False),
}
ON_PIPE = {"poc1", "poc2"}
_RUNS = {}


def run(case):
    """(port encoder, port payloads, jm_tpu encoder, jm_tpu payloads) of a
    case, encoded once."""
    if case not in _RUNS:
        frames = make_frames(W, H, N)
        kw = dict(width=W, height=H, qp=QP, search_range=16, **CASES[case])
        rd = kw.pop("device_rd", True)
        jenc = JaxEncoder(JaxConfig(pipeline="device", device_rd=rd, **kw))
        want = jenc.encode_stream(frames)
        enc = Encoder(EncoderConfig(device_rd=rd, **kw), device="cpu")
        _RUNS[case] = (enc, enc.encode_stream(frames), jenc, want)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_payloads_byte_identical(case):
    enc, got, _jenc, want = run(case)
    assert len(got) == len(want) == N
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {i} payload differs"


@pytest.mark.parametrize("case", list(CASES))
def test_recon_and_qp_equal(case):
    enc, _got, jenc, _want = run(case)
    assert [r["type"] for r in enc.results] == \
        [r["type"] for r in jenc.results]
    assert [r["qp"] for r in enc.results] == [r["qp"] for r in jenc.results]
    for a, b in zip(enc.results, jenc.results):
        for plane in "YUV":
            assert np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane))


@pytest.mark.parametrize("case", list(CASES))
def test_stream_decodes_to_recon(case):
    enc, got, _jenc, _want = run(case)
    data = b"".join(got)
    for dec in (H264Decoder(device="cpu"), JaxDecoder()):
        out = dec.decode_annexb(data)
        assert len(out) == N
        for frame, res in zip(out, enc.results):
            for plane in "YUV":
                assert np.array_equal(getattr(frame, plane),
                                      getattr(res["frame"], plane))


@pytest.mark.parametrize("case", list(CASES))
def test_route_and_slices(case):
    """POC types 1 and 2 stay on the pipe (no fallback, no overflow here,
    recorded as for POC type 0); every other case takes the per-frame
    path, with the slice count of its plan on each picture."""
    enc, _got, _jenc, _want = run(case)
    assert enc._pipe_ok() == (case in ON_PIPE)
    assert enc.fallbacks == [] and enc.ovf == [] and enc.redispatches == 0
    p_results = enc.results[1:]
    if case in ON_PIPE:
        assert all("intra_mbs" not in r for r in p_results)
    else:
        assert all("intra_mbs" in r for r in p_results)
    cfg = CASES[case]
    if cfg.get("slice_mode") == 1 and "num_slice_groups" not in cfg:
        n_mbs = (W // 16) * (H // 16)
        assert {r["slices"] for r in enc.results} == \
            {-(-n_mbs // cfg["slice_argument"])}
    elif cfg.get("slice_mode") == 2:
        assert enc.results[0]["slices"] > 1
    elif "num_slice_groups" in cfg:
        assert all(r["slices"] == cfg["num_slice_groups"]
                   for r in enc.results)
    else:
        assert all(r["slices"] == 1 for r in enc.results)
