"""The port's lencod / ldecod entry points (jm_tpu_torch/tools, run with
main(argv, device="cpu")) against jm_tpu's on the same cfg files, on the
CPU: a 64x48 clip of 3 frames (the seeded synthetic clip, view 1 its
copy shifted 8 luma / 4 chroma columns), each package writing into a
directory of its own, and every file they write is compared:
- one view: the stream, the recon, the leaky-bucket parameters and the
  stats line; the RTP dump (OutFileMode 1), which ldecod reads back
  (FileFormat 1);
- two views (NumberOfViews 2 with a View1ConfigFile): the stream, and
  view 0's recon (lencod reads view 1's ReconFile name and never writes
  it, as jm_tpu's does); ldecod writes both views into one file sorted
  by POC;
- -ckpt / -resume: a run killed after its checkpoint and resumed writes
  the uninterrupted run's stream, which is jm_tpu's."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from jm_tpu.tools import ldecod as jldecod
from jm_tpu.tools import lencod as jlencod
from jm_tpu_torch.encoder.encoder import Encoder
from jm_tpu_torch.tools import ldecod, lencod

from test_pipe_stream import make_frames
from torch_streams import one_torch_thread  # noqa: F401

W, H, N = 64, 48, 3


def _yuv(path, frames):
    with open(path, "wb") as fh:
        for f in frames:
            fh.write(b"".join(np.ascontiguousarray(p).tobytes() for p in f))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("src")
    left = make_frames(W, H, N)
    right = [(np.roll(Y, -8, axis=1), np.roll(U, -4, axis=1),
              np.roll(V, -4, axis=1)) for Y, U, V in left]
    _yuv(d / "left.yuv", left)
    _yuv(d / "right.yuv", right)
    return d


def _cfg(d, src, views: int, extra: str = "") -> str:
    text = f'''
InputFile = "{src / 'left.yuv'}"
OutputFile = "{d / 'out.264'}"
ReconFile = "{d / 'rec.yuv'}"
StatsFile = "{d / 'stats.dat'}"
SourceWidth = {W}
SourceHeight = {H}
FramesToBeEncoded = {N}
QPISlice = 30
QPPSlice = 31
IntraPeriod = 2
LeakyBucketParamFile = "{d / 'leaky.cfg'}"
{extra}
'''
    if views == 2:
        (d / "view1.cfg").write_text(f'InputFile = "{src / "right.yuv"}"\n'
                                     f'ReconFile = "{d / "rec1.yuv"}"\n')
        text += f'NumberOfViews = 2\nView1ConfigFile = "{d / "view1.cfg"}"\n'
    (d / "enc.cfg").write_text(text)
    return str(d / "enc.cfg")


def _run(main, *args, **kw):
    with redirect_stdout(io.StringIO()):
        assert main(*args, **kw) == 0


def _both(tmp_path, sources, views, extra="", ckpt=False):
    """lencod of each package on the same cfg, in a directory each (with
    ckpt, checkpointing into it)."""
    out = {}
    for name, main, kw in (("jm", jlencod.main, {}),
                           ("port", lencod.main, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        argv = ["-ckpt", str(d / "job.ckpt")] if ckpt else []
        _run(main, ["-d", _cfg(d, sources, views, extra), *argv], **kw)
        out[name] = d
    return out["jm"], out["port"]


def _same_files(a, b, names):
    for n in names:
        assert (b / n).read_bytes() == (a / n).read_bytes(), n


def _decode(dirs, extra=()):
    for d, main, kw in ((dirs[0], jldecod.main, {}),
                        (dirs[1], ldecod.main, {"device": "cpu"})):
        _run(main, ["-i", str(d / "out.264"), "-o", str(d / "dec.yuv"),
                    "-r", str(d / "rec.yuv"), *extra], **kw)
    _same_files(*dirs, ["dec.yuv"])


def test_one_view(tmp_path, sources):
    dirs = _both(tmp_path, sources, 1, "NumberLeakyBuckets = 2")
    _same_files(*dirs, ["out.264", "rec.yuv", "leaky.cfg", "stats.dat"])
    _decode(dirs)
    # ldecod sorts the frames by POC alone, as jm_tpu's does, so the IDR
    # of frame 2 (POC 0) comes before frame 1 (POC 2)
    frame = W * H * 3 // 2
    rec = (dirs[1] / "rec.yuv").read_bytes()
    assert (dirs[1] / "dec.yuv").read_bytes() == b"".join(
        rec[k * frame:(k + 1) * frame] for k in (0, 2, 1))


def test_search_range_32(tmp_path, sources):
    """lencod puts its cfg on the host pipeline, whose full search takes
    SearchRange up to the planes' padding (32)."""
    dirs = _both(tmp_path, sources, 1, "SearchRange = 32")
    _same_files(*dirs, ["out.264", "rec.yuv"])
    _decode(dirs)


def test_rtp_out_file(tmp_path, sources):
    dirs = _both(tmp_path, sources, 1, "OutFileMode = 1")
    _same_files(*dirs, ["out.264", "rec.yuv"])
    assert (dirs[1] / "out.264").read_bytes()[:4] != b"\x00\x00\x00\x01"
    _decode(dirs, ["-p", "FileFormat=1"])


def test_two_views(tmp_path, sources):
    dirs = _both(tmp_path, sources, 2)
    _same_files(*dirs, ["out.264", "rec.yuv"])
    for d in dirs:
        assert not (d / "rec1.yuv").exists()
    _decode(dirs)
    frame = W * H * 3 // 2
    assert len((dirs[1] / "dec.yuv").read_bytes()) == 2 * N * frame


def test_checkpoint_resume(tmp_path, sources, monkeypatch):
    """A run killed in the frame after its checkpoint leaves the
    checkpoint and the .part stream; -resume finishes the uninterrupted
    run's stream (jm_tpu's)."""
    jm, port = _both(tmp_path, sources, 1, ckpt=True)
    _same_files(jm, port, ["out.264"])
    d = tmp_path / "killed"
    d.mkdir()
    argv = ["-d", _cfg(d, sources, 1), "-ckpt", str(d / "job.ckpt")]
    real = Encoder.encode_frame
    calls = {"n": 0}

    def killer(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt
        return real(self, *a, **kw)

    monkeypatch.setattr(Encoder, "encode_frame", killer)
    with pytest.raises(KeyboardInterrupt):
        _run(lencod.main, argv, device="cpu")
    monkeypatch.setattr(Encoder, "encode_frame", real)
    assert (d / "job.ckpt").exists() and (d / "out.264.part").exists()
    assert not (d / "out.264").exists()
    _run(lencod.main, argv + ["-resume"], device="cpu")
    assert (d / "out.264").read_bytes() == (jm / "out.264").read_bytes()
    assert not (d / "out.264.part").exists()
