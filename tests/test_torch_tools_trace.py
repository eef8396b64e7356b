"""The port's syntax-element trace (jm_tpu_torch/tools/trace.py, run with
device="cpu") against jm_tpu's on the CPU:
- line for line (bit position, width, kind, label, value) on CAVLC
  streams of jm_tpu's Encoder: an I P P stream, an enable_vui SPS, long-
  term references and MMCO 1, forced I_PCM MBs (the last three reach the
  port's reading helpers that jm_tpu reads inline), the full VUI / HRD
  stream with its SEI, and the goldens cif_dp.264 (data partitions),
  cavlc_b.264 (B slices: the port's B motion helpers), y422c.264 (4:2:2)
  and hi10c.264 (High 10), and field pictures above 8 bits and at 4:2:2
  (the port's field stream under a High 10 SPS; its 4:2:2 host coders'
  pictures re-framed as fields, 10 bits);
- on the CABAC goldens, whose slices neither package traces (both CABAC
  engines take only their native reader): the element lines are equal
  and the parse stops at the same NALUs (the text after "stopped:"
  names each package's own reader);
- parse_trace / diff_traces of both packages agree on a trace, an
  injected divergence and a JM trace_dec.txt line;
- a decode after a trace is unaffected (the patched modules restored);
- the entry points default to the card and raise without one."""

import re

import numpy as np
import pytest
import torch

from jm_tpu.tools import trace as jtrace
from jm_tpu_torch import native as N
from jm_tpu_torch.bitstream import bitreader
from jm_tpu_torch.decoder import header, mb_parse, parset, sei
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.tools import trace

from torch_streams import field_stream, host_fields, reheaded
from torch_tools_streams import CASES, GOLDEN, case_stream, hrd_stream

# field streams of 2 frames at 64x64 (fields of 4 x 2 MBs)
FIELDS = {"field_high10": lambda: reheaded(field_stream(2, 64, 64), 110, 10),
          "field_y422_10bit": lambda: reheaded(host_fields(4, 64, 64), 122,
                                               10)}

STOPPED = re.compile(r"^(!! parse stopped: )\w+: .*$", re.M)


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(name):
        if name not in cache:
            if name == "hrd":
                cache[name] = hrd_stream()
            elif name in FIELDS:
                cache[name] = FIELDS[name]()
            elif name in CASES:
                cache[name] = case_stream(name)
            else:
                cache[name] = (GOLDEN / f"{name}.264").read_bytes()
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES) + ["hrd", "cif_dp", "cavlc_b",
                                                "y422c", "hi10c"]
                         + list(FIELDS))
def test_trace_matches_jm_line_for_line(name, streams, monkeypatch):
    data = streams(name)
    got = trace.trace_stream(data, device="cpu")
    want = jtrace.trace_stream(data)
    assert got == want
    assert "!! parse stopped" not in got
    elems = trace.parse_trace(got)
    assert len(elems) > 500
    labels = {e[1].split(":")[0] for e in elems}
    assert {"_parse_sps_data", "parse_pps", "parse_slice_header"} <= labels
    if name in ("vui", "hrd"):
        assert "_parse_vui" in labels
    if name == "hrd":
        assert {"_parse_hrd", "_parse_pic_timing",
                "_parse_buffering_period"} <= labels
    if name == "ipcm":
        assert "_parse_ipcm" in labels
    if name == "cavlc_b":
        assert {"_parse_b_mb", "read_part_mvd"} <= labels
    if name in ("long_term", "mmco"):
        # the slices carry MMCO commands (read by the port's _read_mmco)
        seen = []
        real = header._read_mmco

        def spy(br):
            ops = real(br)
            seen.extend(ops)
            return ops

        monkeypatch.setattr(header, "_read_mmco", spy)
        H264Decoder(device="cpu").decode_annexb(data)
        assert seen


@pytest.mark.parametrize("name", ["cabac_pp", "high8x8", "main9t",
                                  "stereo_jm"])
def test_cabac_trace_stops_where_jm_does(name, streams):
    data = streams(name)
    got = trace.trace_stream(data, device="cpu")
    want = jtrace.trace_stream(data)
    assert "jm_torch_native.BitReader" in got
    assert STOPPED.sub(r"\1", got) == STOPPED.sub(r"\1", want)
    assert got.count("!! parse stopped") == want.count("!! parse stopped") > 0


def test_max_nalus_and_the_cli(streams, tmp_path, capsys):
    data = streams("ipp")
    assert trace.trace_stream(data, max_nalus=3, device="cpu") == \
        jtrace.trace_stream(data, max_nalus=3)
    f = tmp_path / "s.264"
    f.write_bytes(data)
    assert trace.main([str(f), "3"], device="cpu") == 0
    got = capsys.readouterr().out
    assert jtrace.main([str(f), "3"]) == 0
    assert got == capsys.readouterr().out
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text(got)
    b.write_text(got.replace("(     30)", "(     31)", 1))
    assert trace.main(["--diff", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert jtrace.main(["--diff", str(a), str(b)]) == 0
    assert out == capsys.readouterr().out and out.startswith("DIVERGE")


def test_diff_and_parse_match_jm(streams):
    t = trace.trace_stream(streams("ipp"), max_nalus=3, device="cpu")
    assert trace.diff_traces(t, t) == jtrace.diff_traces(t, t)
    assert trace.diff_traces(t, t).startswith("IDENTICAL")
    lines = t.splitlines()
    for i, ln in enumerate(lines):
        if ln.startswith("@") and "(     30)" in ln:
            lines[i] = ln.replace("(     30)", "(     31)")
            break
    else:
        raise AssertionError("no value 30 in the trace")
    bad = "\n".join(lines)
    assert trace.diff_traces(t, bad) == jtrace.diff_traces(t, bad)
    assert trace.diff_traces(t, bad).startswith("DIVERGE")
    short = "\n".join(t.splitlines()[:-5])
    assert trace.diff_traces(t, short) == jtrace.diff_traces(t, short)
    assert trace.parse_trace(t) == jtrace.parse_trace(t)
    jm = ("@0     SPS: profile_idc                    01000010 ( 66) \n"
          "@8     SPS: constrained_set0_flag                 0 (  0) \n")
    assert trace.parse_trace(jm) == jtrace.parse_trace(jm) == [
        (0, "SPS: profile_idc", 66), (8, "SPS: constrained_set0_flag", 0)]


def test_decoder_unaffected_after_trace(streams):
    """The patched readers, the I_PCM sample reader and the native parse
    switch are restored: a decode after a trace takes the native parser
    and gives the same frames."""
    data = streams("ipcm")
    before = H264Decoder(device="cpu").decode_annexb(data)
    trace.trace_stream(data, max_nalus=2, device="cpu")
    assert parset.BitReader is header.BitReader is bitreader.BitReader
    assert sei.BitReader is bitreader.PyBitReader
    assert mb_parse.read_pcm_samples.__module__ == mb_parse.__name__
    assert mb_parse.MBParser._parse_native.__name__ == "_parse_native"
    N.reset_routes()
    out = H264Decoder(device="cpu").decode_annexb(data)
    assert len(out) == len(before) == 2
    for a, b in zip(out, before):
        assert np.array_equal(a.Y, b.Y) and np.array_equal(a.U, b.U)
    assert N.routes["parse"]["native"] + N.routes["parse"]["rerun"] == 2


def test_trace_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tmp_path / "s.264"
    f.write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        trace.trace_stream(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        trace.main([str(f)])
