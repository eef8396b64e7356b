"""The port's Encoder with pipeline="host" (every picture coded MB by MB
by the serial host coders: encoder/intra_host.py, p_host.py, b_host.py)
against jm_tpu's Encoder with pipeline="host", its default, on the CPU,
exactly (the codec is integer-exact: the tolerance is zero): the
payloads byte for byte, the reconstructed pictures, and the port's
decode of the stream equal to the encoder's recon, on the 96x80 QP 30
clip of tests/test_pipe_stream.py (3 frames; 5 for the pyramid and the
open GOP, through encode_frame and flush), for jm_tpu's default
configuration and beside each option of the port's earlier slices:
slices (modes 1 and 2), FMO, frame rate control, qp_p, POC types 1 and
2, data partitioning, long-term references with list reordering, MMCO,
redundant pictures, the loop filter off, SEI and VUI, intra refresh,
CABAC with cabac_adapt_init, B pictures (IbP, a pyramid, open GOP with
CRA marking) and weighted prediction (explicit P, implicit B). Also: the
port's EncoderConfig(pipeline="host") writes jm_tpu's EncoderConfig()
stream, and device_rd does not change it."""

import pytest

from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

import torch_streams as S
from torch_streams import one_torch_thread  # noqa: F401
from test_pipe_stream import make_frames

W, H, QP = S.W, S.H, S.QP
CASES = {
    "default": {},
    "slice_mode1": dict(slice_mode=1, slice_argument=6),
    "slice_mode2": dict(slice_mode=2, slice_argument=120),
    "fmo_t1": dict(num_slice_groups=2, slice_group_map_type=1),
    "rc": dict(rc_enable=True, rc_bitrate=46000.0),
    "qp_p": dict(qp_p=33),
    "poc1": dict(poc_type=1),
    "poc2": dict(poc_type=2),
    "dp": dict(data_partition=1),
    "long_term_reorder": dict(long_term_period=2, ref_reorder=1),
    "poc_mem_mgmt": dict(poc_mem_mgmt=1),
    "redundant": dict(redundant_period=2),
    "deblock_off": dict(deblock=False),
    "vui_sei": dict(enable_vui=True, sei_user_data=bytes(range(16))),
    "intra_refresh": dict(intra_mb_refresh=4),
    "cabac_adapt_slices": dict(entropy="cabac", cabac_adapt_init=True,
                               slice_mode=1, slice_argument=10),
    "ibp": dict(num_b=1),
    "pyramid": dict(num_b=3, hierarchical=1),
    "open_gop_cra": dict(num_b=1, intra_period=2, sei_recovery_point=True,
                         mmco_policy="cra"),
    "wp": dict(weighted_pred=1),
    "wp_implicit_b": dict(num_b=1, weighted_bipred=2),
}
_RUNS = {}


def _run(case):
    """A case encoded once per process (torch_streams.frame_run: 3
    frames; 5 for the pyramid and the open GOP)."""
    if case not in _RUNS:
        cfg = CASES[case]
        n = 5 if cfg.get("num_b", 0) > 1 or cfg.get("intra_period") else 3
        _RUNS[case] = S.frame_run(cfg, n)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_host_pipeline_payloads_match_jm(case):
    S.check_frame_run_payloads(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_host_pipeline_recon_matches_jm(case):
    S.check_frame_run_recon(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_host_pipeline_stream_decodes_to_recon(case):
    S.check_frame_run_decodes(_run(case))


@pytest.mark.parametrize("device_rd", [True, False])
def test_port_host_config_writes_jm_default_stream(device_rd):
    """EncoderConfig(pipeline="host") is jm_tpu's EncoderConfig(), with
    either value of device_rd, through encode_stream."""
    frames = make_frames(W, H, 3)
    want = JaxEncoder(JaxConfig(width=W, height=H, qp=QP)) \
        .encode_stream(frames)
    enc = Encoder(EncoderConfig(width=W, height=H, qp=QP, pipeline="host",
                                device_rd=device_rd), device="cpu")
    assert enc.encode_stream(frames) == want
    assert [r["type"] for r in enc.results] == ["I", "P", "P"]
