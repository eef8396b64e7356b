"""The port's encoder (device="cpu") against jm_tpu's
Encoder(pipeline="device") on the error-resilience and reference-
management configurations of tests/torch_resilience.py (96x80, QP 30,
6 frames): the loop filter off, VUI timing with a user-data SEI,
long-term anchors (device RD and md_low), POC-based MMCO, list
reordering with a long-term anchor, redundant pictures (device RD and
md_low) and data partitioning (alone, with slice_mode 1, with FMO map
type 1, with a long-term anchor, and with intra MBs in P slices by
intra refresh), and a weighted bi-prediction PPS without B pictures.
Each case through ``encode_frame``, and through
``encode_stream`` where that takes the per-frame path (where it stays
on the pipe the case runs in tests/test_torch_encoder.py or
test_torch_fallback.py, which compile jm_tpu's pipe anyway). Per case
and route: byte-identical payloads, equal recon, a decode by both
decoders equal to the recon, the pipe taken alike and the syntax of the
case in the stream. Also: redundant pictures with data partitioning
raise as in jm_tpu, the loop filter runs once per primary picture
(never on a redundant coding, never with deblock=False), and every
partitioned slice goes through the Python serializer and parser,
counted as such."""

import pytest
import torch

import torch_resilience as R
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch import native
from jm_tpu_torch.bitstream.nal import split_annexb
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder import encoder as port_encoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames

PAIRS = [(c, r) for c, cfg in R.CASES.items() for r in R.ROUTES
         if r == "frame" or not R.on_pipe(cfg)]
PARAMS = [(R.CASES[c], r) for c, r in PAIRS]
IDS = [f"{c}-{r}" for c, r in PAIRS]



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU encodes and decodes are many small tensor ops,
    which more threads only slow down beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("cfg,route", PARAMS, ids=IDS)
def test_payloads_byte_identical(cfg, route):
    R.check_payloads(cfg, route)


@pytest.mark.parametrize("cfg,route", PARAMS, ids=IDS)
def test_recon_equal(cfg, route):
    R.check_recon(cfg, route)


@pytest.mark.parametrize("cfg,route", PARAMS, ids=IDS)
def test_stream_decodes_to_recon(cfg, route):
    R.check_decodes(cfg, route)


@pytest.mark.parametrize("cfg,route", PARAMS, ids=IDS)
def test_pipe_ok_and_syntax(cfg, route):
    R.check_pipe_and_syntax(cfg, route)


def test_redundant_with_data_partitioning_raises():
    for make in (lambda **kw: Encoder(EncoderConfig(**kw), device="cpu"),
                 lambda **kw: JaxEncoder(JaxConfig(pipeline="device",
                                                   **kw))):
        with pytest.raises(NotImplementedError, match="redundant"):
            make(width=R.W, height=R.H, redundant_period=2,
                 data_partition=1)


@pytest.mark.parametrize("kw,per_picture", [
    (dict(redundant_period=1), 1), (dict(deblock=False), 0)])
def test_deblock_calls(monkeypatch, kw, per_picture):
    """The loop filter runs once per primary picture: the redundant
    codings are not deblocked, and deblock=False runs it on none."""
    calls = []
    deblock = port_encoder.deblock

    def counted(*a, **k):
        calls.append(1)
        return deblock(*a, **k)

    monkeypatch.setattr(port_encoder, "deblock", counted)
    enc = Encoder(EncoderConfig(width=R.W, height=R.H, qp=R.QP, **kw),
                  device="cpu")
    native.reset_routes()
    payloads = [enc.encode_frame(*f) for f in make_frames(R.W, R.H, 3)]
    assert len(calls) == 3 * per_picture
    if kw.get("redundant_period"):
        # the IDR, two primaries and two redundant codings
        assert native.routes["serialize"]["native"] == 5
        assert sum(len(split_annexb(p)) for p in payloads) == 3 + 2 + 2


def test_dp_routes():
    """Every P slice of a partitioned stream is serialized and parsed on
    the Python route named dp; the IDR keeps the native ones."""
    native.reset_routes()
    enc = Encoder(EncoderConfig(width=R.W, height=R.H, qp=R.QP,
                                **R.CASES["dp_slices"]), device="cpu")
    data = b"".join(enc.encode_stream(make_frames(R.W, R.H, 3)))
    n_i, n_p = enc.results[0]["slices"], enc.results[1]["slices"] * 2
    assert native.routes["dp"] == {"serialize": n_p, "parse": 0}
    assert native.routes["serialize"] == {"native": n_i, "python": 0}
    native.reset_routes()
    H264Decoder(device="cpu").decode_annexb(data)
    assert native.routes["dp"] == {"serialize": 0, "parse": n_p}
    assert native.routes["parse"]["native"] == n_i
