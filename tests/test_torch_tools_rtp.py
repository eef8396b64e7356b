"""The port's RTP tools (jm_tpu_torch/tools/rtpdump.py, rtp_loss.py, over
the port's bitstream/rtp.py) against jm_tpu's on the CPU:
- rtpdump prints jm_tpu's report on the stream of tests/test_rtp.py::
  test_rtpdump_cli, and the same usage / error lines;
- rtp_loss --seed 7 at 20 % loss keeping 2 leading packets writes
  jm_tpu's file and prints its "lost packet" lines; 0 % keeps every
  packet; the lossy dump decodes with conceal_mode=1 in the port as in
  jm_tpu."""

import numpy as np
import pytest

from jm_tpu.bitstream.rtp import annexb_to_rtp as jm_annexb_to_rtp
from jm_tpu.decoder.decoder import H264Decoder as JDecoder
from jm_tpu.tools import rtp_loss as jrtp_loss
from jm_tpu.tools import rtpdump as jrtpdump
from jm_tpu_torch.bitstream.rtp import (annexb_to_rtp, read_rtp_dump,
                                        rtp_to_annexb)
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.tools import rtp_loss, rtpdump

from test_rtp import _golden_stream
from torch_tools_streams import jm_stream


def _run(capsys, fn, argv):
    rc = fn(argv)
    return rc, capsys.readouterr().out


def test_rtpdump_matches_jm(tmp_path, capsys):
    dump = annexb_to_rtp(_golden_stream())
    assert dump == jm_annexb_to_rtp(_golden_stream())
    f = tmp_path / "s.rtp"
    f.write_bytes(dump)
    rc, out = _run(capsys, rtpdump.main, [str(f)])
    assert (rc, out) == _run(capsys, jrtpdump.main, [str(f)])
    assert rc == 0 and out.count("packet #") == len(read_rtp_dump(dump))
    for argv in ([], [str(tmp_path / "missing.rtp")]):
        assert _run(capsys, rtpdump.main, argv) == \
            _run(capsys, jrtpdump.main, argv)


@pytest.fixture(scope="module")
def dump():
    return annexb_to_rtp(jm_stream(6))


def test_rtp_loss_seed_matches_jm(tmp_path, capsys, dump):
    src = tmp_path / "in.rtp"
    src.write_bytes(dump)
    ours, theirs = tmp_path / "ours.rtp", tmp_path / "theirs.rtp"
    rc, out = _run(capsys, rtp_loss.main,
                   [str(src), str(ours), "20", "2", "--seed", "7"])
    assert (rc, out) == _run(capsys, jrtp_loss.main,
                             [str(src), str(theirs), "20", "2", "--seed",
                              "7"])
    assert rc == 0 and "lost packet #" in out
    assert ours.read_bytes() == theirs.read_bytes()
    kept = read_rtp_dump(ours.read_bytes())
    assert [p.seq for p in kept][:2] == [0, 1]
    assert len(kept) + out.count("lost packet") == len(read_rtp_dump(dump))
    # the lossy stream decodes with concealment as in jm_tpu
    lossy = rtp_to_annexb(ours.read_bytes())
    frames = H264Decoder(device="cpu", conceal_mode=1).decode_annexb(lossy)
    jframes = JDecoder(conceal_mode=1).decode_annexb(lossy)
    assert len(frames) == len(jframes) > 0
    for a, b in zip(frames, jframes):
        assert a.poc == b.poc
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p))
    # 0 % loss keeps everything; a bad command line is jm_tpu's
    assert _run(capsys, rtp_loss.main, [str(src), str(ours), "0"]) == (0, "")
    assert ours.read_bytes() == dump
    assert _run(capsys, rtp_loss.main, [str(src)]) == \
        _run(capsys, jrtp_loss.main, [str(src)])
