"""The port's parallel axes (jm_tpu_torch/parallel) against jm_tpu's
(jm_tpu/parallel): the MB-row sharded md_low P step and the GOP pipeline,
over lists of torch devices in one process ("cpu" repeated here, as
jm_tpu's tests run on the 8 virtual CPU devices of tests/conftest.py).

- every band's fields of the sharded step equal jm_tpu's
  p_frame_step_sharded on two devices;
- the halo rows and the band planes equal the whole picture's rows at 8
  shards (one MB row each: the multi-hop case);
- the port's sp_shards 2 / 4 / 8 streams and recon equal jm_tpu's
  sharded stream (which tests/test_multichip.py holds equal to the
  unsharded one), with sp_steps counting the sharded P pictures; where
  the step falls through (mb_h % n, device_rd, sp_shards 1, a range
  above 16) the bytes are the same and sp_steps is 0;
- the meshes refuse too few devices;
- the five cases of tests/test_gop_parallel.py, split_gops and the
  refusals of encode_gops_parallel, against jm_tpu's serial Encoder."""

import numpy as np
import pytest
import torch

from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu.parallel import gop_pipeline as JGOP
from jm_tpu.parallel import sp_pipeline as JSP
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.encoder.encoder import (Encoder, EncoderConfig, lambda_me,
                                          lambda_mode4)
from jm_tpu_torch.ops import enc as E
from jm_tpu_torch.parallel import gop_pipeline as GOP
from jm_tpu_torch.parallel import mesh as M
from jm_tpu_torch.parallel import sp_pipeline as SP

from test_gop_parallel import _frames as gop_frames
from test_multichip import _frames as sharded_frames
from torch_streams import one_torch_thread  # noqa: F401

W, H = 96, 128                  # mb_h 8: 2, 4 and 8 shards divide it
GW, GH = 96, 64                 # the GOP cases' size (mb_h 4)
CPU = torch.device("cpu")


def _recon(results) -> bytes:
    return b"".join(r["frame"].Y.tobytes() + r["frame"].U.tobytes()
                    + r["frame"].V.tobytes()
                    for r in sorted(results, key=lambda r: r["disp"]))


def _port(frames, mesh=None, **kw):
    cfg = dict(width=W, height=H, qp=28, pipeline="device",
               device_rd=False)
    cfg.update(kw)
    enc = Encoder(EncoderConfig(**cfg), device="cpu")
    enc._sp_mesh = mesh
    data = b"".join(enc.encode_frame(*f) for f in frames)
    return data, _recon(enc.results), enc


@pytest.fixture(scope="module")
def sharded():
    """jm_tpu's sp_shards=2 stream of test_multichip's clip, its recon and
    its encoder (whose mesh and compiled step the band test reuses)."""
    frames = sharded_frames()
    enc = JaxEncoder(JaxConfig(width=W, height=H, qp=28, pipeline="device",
                               sp_shards=2))
    data = b"".join(enc.encode_frame(*f) for f in frames)
    return frames, data, _recon(enc.results), enc


def test_band_fields_match_jm(sharded):
    import jax
    frames, _, _, jenc = sharded
    ref = jenc.results[0]["frame"]             # the IDR's recon
    Y, U, V = frames[1]
    qp = 28
    args = (qp, chroma_qp(qp, 0), lambda_me(qp), lambda_mode4(qp))
    mb_w, mb_h = W // 16, H // 16
    want = jax.device_get(JSP.p_frame_step_sharded(
        jenc._sp_mesh, Y, U, V, ref.Y, ref.U, ref.V, *args, mb_w=mb_w,
        mb_h=mb_h, sr=16))
    t = [torch.from_numpy(np.ascontiguousarray(p))
         for p in (Y, U, V, ref.Y, ref.U, ref.V)]
    bands = SP.p_bands([CPU, CPU], *t, *args, mb_w=mb_w, mb_h=mb_h, sr=16)
    for i, band in enumerate(bands):
        assert set(band) == set(want)
        for k, v in band.items():
            r = want[k].shape[0] // 2         # MBs, or rows of a plane
            w = np.asarray(want[k])[i * r:(i + 1) * r]
            assert v.numpy().dtype == w.dtype, k
            assert np.array_equal(v.numpy(), w), (i, k)
    whole = SP.p_frame_step_sharded([CPU, CPU], *t, *args, mb_w=mb_w,
                                    mb_h=mb_h, sr=16)
    for k, v in whole.items():
        assert np.array_equal(v.numpy(), np.asarray(want[k])), k


def test_halo_and_band_planes_at_8_shards():
    """Eight bands of one MB row each: the 35-row luma halo takes three
    hops, and every band's extended rows and planes are the rows of the
    whole picture's edge-padded plane and plane set."""
    rng = np.random.default_rng(7)
    plane = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8))
    n, band_h = 8, H // 8
    mesh = [CPU] * n
    bands = [plane[i * band_h:(i + 1) * band_h] for i in range(n)]
    full = E.edge_pad(plane, SP.HALO + 3)[:, SP.HALO + 3:-(SP.HALO + 3)]
    for rows in (SP.HALO + 3, SP.HALO // 2, 5):
        ext = SP._extend_band(bands, mesh, rows, H)
        for i, e in enumerate(ext):
            lo = SP.HALO + 3 + i * band_h - rows
            assert torch.equal(e, full[lo:lo + band_h + 2 * rows]), (rows, i)
    planes = E.make_luma_planes(plane)
    for i, e in enumerate(SP._extend_band(bands, mesh, SP.HALO + 3, H)):
        got = SP._make_luma_planes_band(e, band_h + 2 * SP.HALO, W)
        assert torch.equal(got, planes[:, i * band_h:
                                       i * band_h + band_h + 2 * SP.HALO])
    # without the edge fix, rows beyond the picture are ppermute's zeros
    top = SP._collect_top_halo(bands, mesh, SP.HALO + 3, edge_fix=False)
    assert not top[0].any() and not top[1][:19].any()
    assert torch.equal(top[1][19:], plane[:band_h])
    assert torch.equal(top[3], plane[3 * band_h - 35:3 * band_h])


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_stream_matches_jm(sharded, shards):
    frames, data, rec, _ = sharded
    got, got_rec, enc = _port(frames, [CPU] * shards, sp_shards=shards)
    assert got == data and len(got) == 4647
    assert got_rec == rec
    assert enc.sp_steps == len(frames) - 1


@pytest.mark.parametrize("kw", [{"sp_shards": 3}, {"sp_shards": 1}],
                         ids=["mb_h_not_divisible", "one_shard"])
def test_fall_through_keeps_the_bytes(sharded, kw):
    """3 shards at mb_h 8 and sp_shards 1 take the unsharded step (jm_tpu
    falls through the same way, and its sharded stream is its unsharded
    one)."""
    frames, data, rec, _ = sharded
    got, got_rec, enc = _port(frames, **kw)
    assert (got, got_rec, enc.sp_steps) == (data, rec, 0)


def test_range_above_16_falls_through_and_raises(sharded):
    """At SR 17 with sp_shards 2 both packages skip the sharded step, and
    the unsharded one raises at the first P picture."""
    frames = sharded[0]
    jenc = JaxEncoder(JaxConfig(width=W, height=H, qp=28, pipeline="device",
                                sp_shards=2, search_range=17))
    enc = Encoder(EncoderConfig(width=W, height=H, qp=28, pipeline="device",
                                device_rd=False, sp_shards=2,
                                search_range=17), device="cpu")
    enc._sp_mesh = [CPU, CPU]
    for e in (jenc, enc):
        e.encode_frame(*frames[0])
        with pytest.raises(ValueError, match="plane padding"):
            e.encode_frame(*frames[1])
    assert enc.sp_steps == 0


def test_meshes_refuse_too_few_devices():
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        SP.make_sp_mesh(2, device_type="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        M.make_mesh(2, 2, [CPU] * 3)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        JSP.make_sp_mesh(9)
    assert M.make_mesh(2, 2, ["cpu"] * 4) == [[CPU, CPU], [CPU, CPU]]
    assert M.make_mesh(1, 1, device_type="cpu") == [[CPU]]
    # without a mesh, the encoder's own (every CPU: one) is too small,
    # at the first P picture, as jm_tpu's with fewer devices than shards
    frames = sharded_frames(2)
    enc = Encoder(EncoderConfig(width=W, height=H, pipeline="device",
                                device_rd=False, sp_shards=2), device="cpu")
    enc.encode_frame(*frames[0])
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        enc.encode_frame(*frames[1])


# ---- the GOP pipeline (tests/test_gop_parallel.py's cases) ---------------

def _gop_cfg(cls, sp_shards: int, device_rd: bool):
    return cls(width=GW, height=GH, qp=30, intra_period=3, pipeline="device",
               sp_shards=sp_shards, search_range=8, device_rd=device_rd)


@pytest.fixture(scope="module")
def serial():
    """jm_tpu's serial stream of test_gop_parallel's clip, md_low and
    device_rd (sp_shards 1: its sharded stream is the same)."""
    frames = gop_frames(GW, GH, 9)
    out = {}
    for rd in (False, True):
        enc = JaxEncoder(_gop_cfg(JaxConfig, 1, rd))
        out[rd] = b"".join(enc.encode_frame(*f) for f in frames) \
            + enc.flush()
    return frames, out


def test_split_gops():
    for n, ip in ((10, 4), (8, 4), (5, 0), (9, 3), (1, 3)):
        assert GOP.split_gops(n, ip) == JGOP.split_gops(n, ip)
    assert GOP.split_gops(10, 4) == [(0, 4), (4, 8), (8, 10)]


@pytest.mark.parametrize("n_dp,n_sp,sp_shards,device_rd", [
    (2, 1, 1, False),
    (4, 1, 1, False),
    (2, 4, 4, False),
    (2, 1, 1, True),
    (4, 1, 1, True),
])
def test_gop_parallel_matches_jm_serial(serial, n_dp, n_sp, sp_shards,
                                        device_rd):
    frames, want = serial
    cfg = _gop_cfg(EncoderConfig, sp_shards, device_rd)
    got, results = GOP.encode_gops_parallel(frames, cfg, n_dp=n_dp,
                                            n_sp=n_sp,
                                            devices=["cpu"] * (n_dp * n_sp))
    assert got == want[device_rd]
    assert [r["disp"] for r in results] == list(range(len(frames)))
    assert all(r.get("frame") is not None for r in results)


def test_device_rd_falls_through(serial):
    """sp_shards 2 with device_rd: the unsharded RD step, jm_tpu's bytes."""
    frames, want = serial
    enc = Encoder(_gop_cfg(EncoderConfig, 2, True), device="cpu")
    enc._sp_mesh = [CPU, CPU]
    got = b"".join(enc.encode_frame(*f) for f in frames) + enc.flush()
    assert (got, enc.sp_steps) == (want[True], 0)


@pytest.mark.parametrize("kw", [{}, {"intra_period": 3, "num_b": 1},
                                {"intra_period": 3, "rc_enable": True,
                                 "rc_bitrate": 100000}],
                         ids=["open_gop", "b_pictures", "rate_control"])
def test_gop_parallel_refusals_are_jm_tpus(kw):
    frames = gop_frames(GW, GH, 4)
    with pytest.raises(ValueError) as jm:
        JGOP.encode_gops_parallel(frames, JaxConfig(width=GW, height=GH,
                                                    qp=30, **kw), n_dp=2)
    with pytest.raises(ValueError) as port:
        GOP.encode_gops_parallel(frames, EncoderConfig(width=GW, height=GH,
                                                       qp=30, **kw),
                                 n_dp=2, devices=["cpu"] * 2)
    assert str(port.value) == str(jm.value)
