"""Error concealment in the port's decoder (H264Decoder(conceal_mode=1 /
2)) against jm_tpu's H264Decoder(conceal_mode=...) on the CPU, exactly:
the cases of tests/test_conceal.py and test_conceal_mb.py on streams of
the port's encoder (a panning texture, QP 26), NAL units dropped or cut
with the port's own splitter. Each lossy stream decodes, in both modes,
to jm_tpu's frames (POC, Y, U, V; the tolerance is zero) with jm_tpu's
concealed_count:
- a P picture lost (a frame_num gap): the frame copy (mode 1) or the
  motion copy (mode 2) of the closest reference, and the P pictures
  after it predicted from the concealed frame;
- a gap of one picture in eight, at the POC interpolated between its
  neighbours;
- a picture's only slice cut mid-payload: dropped, the whole frame
  concealed;
- a slice of a P picture (inter concealment by side match), of the IDR
  (spatial concealment) and of a later picture dropped from a stream of
  three slices per picture, and a slice whose payload is replaced mid-MB
  (the corrupt slice's MBs concealed, the later pictures decoded on);
the same at 10 bits (the streams under a High 10 SPS), at 4:2:2 and at
4:2:2 10 bits (the host coders' 4:2:2 streams), with textured chroma;
a field pair lost from a field stream at 8 and 10 bits (no field is
concealed, in either package) and a slice lost from a field picture of
a 4:2:0 10-bit and a 4:2:2 stream of three slices per field; and
without concealment a gap is not noticed (a frame short, as in jm_tpu)
while a dropped slice raises ValueError.

jm_tpu's concealment reads >8-bit and 4:2:2 samples as 8-bit 4:2:0 ones
in places; the port copies that for byte parity, and each copied fault
has a test of its own below (the motion copy, the spatial and the inter
concealment, the concealed frame as a reference). The port's frames keep
the stream's sample type (uint16 above 8 bits) where jm_tpu's motion
copy returns uint8 planes, so frames are compared by value
(np.array_equal), not by dtype."""

import numpy as np
import pytest
import torch

from jm_tpu.decoder import conceal as jm_conceal
from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.decoder.dpb import Frame as JFrame
from jm_tpu.decoder.mb_parse import PictureData as JPictureData
from jm_tpu.ops import interp as jm_interp
from jm_tpu_torch.bitstream.nal import annexb_bytes, split_annexb
from jm_tpu_torch.common.picture import PictureData
from jm_tpu_torch.decoder import conceal
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.ops.consts import PAD
from jm_tpu_torch.ops.enc import prep_ref

from torch_streams import field_stream, one_torch_thread  # noqa: F401
from torch_streams import host_fields, reheaded


def _moving(n, w, h, crows=2, texture=False):
    """Smooth content panning by (3, 2) pixels a frame (tests/
    test_conceal.py _moving_sequence); chroma of 4 crows rows per MB,
    flat, or with texture the luma's own columns (Cb the even, Cr the
    odd ones, rows subsampled at 4:2:0)."""
    yy, xx = np.mgrid[0:h + 32, 0:w + 32]
    base = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
            + 30 * np.sin((xx + yy) / 13.0)).astype(np.uint8)
    out = []
    for i in range(n):
        Y = base[i * 2:i * 2 + h, i * 3:i * 3 + w].copy()
        ch = 4 * crows * h // 16
        if texture:
            rows = Y[::16 // (4 * crows)]
            U, V = rows[:, ::2].copy(), (255 - rows[:, 1::2]).copy()
        else:
            U = np.full((ch, w // 2), 100 + i, np.uint8)
            V = np.full((ch, w // 2), 140 - i, np.uint8)
        out.append((Y, U, V))
    return out


# variant: (chroma_format, bit depth); "8" the streams of tests/
# test_conceal.py (flat chroma), the others with textured chroma
VARIANTS = {"8": (1, 8), "10": (1, 10), "422": (2, 8), "422_10": (2, 10)}


def _encode(n, w=64, h=48, variant="8", **kw):
    cf, bd = VARIANTS[variant]
    enc = Encoder(EncoderConfig(width=w, height=h, qp=26, pipeline="host",
                                chroma_format=cf, **kw), device="cpu")
    data = b"".join(enc.encode_frame(*f) for f in _moving(
        n, w, h, 2 * cf, texture=variant != "8"))
    if bd > 8:
        data = reheaded(data, 110 if cf == 1 else 122, bd)
    return list(split_annexb(data))


def _join(units):
    return b"".join(annexb_bytes(u.nal_ref_idc, u.nal_unit_type, u.rbsp)
                    for u in units)


def _vcl(units):
    return [i for i, u in enumerate(units) if u.nal_unit_type in (1, 5)]


def _streams(variant="8"):
    """name -> the lossy Annex-B bytes of a variant."""
    out = {}
    one = _encode(6, variant=variant)      # SPS, PPS, IDR, P1..P5
    out["lost_p"] = _join(one[:4] + one[5:])
    eight = _encode(8, variant=variant)
    out["gap_poc"] = _join(eight[:5] + eight[6:])
    out["cut_slice"] = _join(one[:4]) + _join(one[4:5])[:16] + \
        _join(one[5:])
    multi = _encode(5, 96, 80, variant=variant, slice_mode=1,
                    slice_argument=10)
    vcl = _vcl(multi)                # three slices per picture
    for name, k in (("lost_p_slice", 4), ("lost_idr_slice", 1),
                    ("lost_last_slice", 14)):
        out[name] = _join([u for i, u in enumerate(multi) if i != vcl[k]])
    raw = _join(multi[vcl[7]:vcl[7] + 1])
    out["corrupt_slice"] = _join(multi[:vcl[7]]) + \
        raw[:len(raw) // 2] + bytes([255] * 8) + _join(multi[vcl[7] + 1:])
    return out


STREAMS = ["lost_p", "gap_poc", "cut_slice", "lost_p_slice",
           "lost_idr_slice", "lost_last_slice", "corrupt_slice"]
# the variants' cases: every stream at 10 bits and at 4:2:2, the four
# that conceal each way at 4:2:2 10 bits
VARIANT_CASES = [(v, n) for v in ("10", "422") for n in STREAMS] + \
    [("422_10", n) for n in ("lost_p", "lost_p_slice", "lost_idr_slice",
                             "corrupt_slice")]


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(variant):
        if variant not in cache:
            cache[variant] = _streams(variant)
        return cache[variant]

    return get


def _decode_both(data, mode):
    """(port decoder, its frames, jm_tpu decoder, its frames), held equal
    by value with the same POCs and concealed_count."""
    dec = H264Decoder(device="cpu", conceal_mode=mode)
    out = dec.decode_annexb(data)
    jdec = JaxDecoder(conceal_mode=mode)
    want = jdec.decode_annexb(data)
    assert [f.poc for f in out] == [f.poc for f in want]
    for i, (a, b) in enumerate(zip(out, want)):
        for p in "YUV":
            assert np.array_equal(getattr(a, p), getattr(b, p)), (i, p)
    assert dec.concealed_count == jdec.concealed_count
    return dec, out, jdec, want


def _check_case(streams, variant, name, mode):
    dec, out, _, _ = _decode_both(streams(variant)[name], mode)
    assert dec.concealed_count > 0
    if name == "gap_poc":
        assert sorted(f.poc for f in out) == list(range(0, 16, 2))
    if name in ("lost_p", "gap_poc", "cut_slice"):
        assert dec.concealed_count == 1       # one whole frame
    else:
        assert dec.concealed_count >= 10      # a slice's MBs
    return out


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("name", STREAMS)
def test_concealment_matches_jm(name, mode, streams, one_torch_thread):
    _check_case(streams, "8", name, mode)


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("variant,name", VARIANT_CASES)
def test_concealment_matches_jm_above_8_bits_and_at_422(
        variant, name, mode, streams, one_torch_thread):
    out = _check_case(streams, variant, name, mode)
    cf, bd = VARIANTS[variant]
    assert out[0].U.shape[0] == out[0].Y.shape[0] // (3 - cf)
    if bd > 8:
        assert out[0].Y.dtype == np.uint16 and int(out[0].Y.max()) > 255


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("bd", [8, 10])
def test_lost_field_pair(bd, mode, one_torch_thread):
    """A field stream of 4 frames with frame 2's two fields dropped: in
    both packages no field is concealed (a field stream keeps its
    reference fields out of the DPB of frames that concealment reads),
    the next pair predicts from the fields before the gap, 3 frames."""
    units = list(split_annexb(field_stream(4, 32, 32)))
    vcl = _vcl(units)
    data = _join([u for i, u in enumerate(units)
                  if i not in (vcl[4], vcl[5])])
    if bd > 8:
        data = reheaded(data, 110, bd)
    dec, out, _, _ = _decode_both(data, mode)
    assert len(out) == 3 and dec.concealed_count == 0
    assert [f.poc for f in out] == [0, 2, 6]


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("variant,k", [("10", 1), ("10", 4), ("422", 1),
                                       ("422", 4)])
def test_lost_slice_of_a_field(variant, k, mode, one_torch_thread):
    """Of a field stream of three slices per field (4:2:0 at 10 bits, and
    4:2:2 at 8: the host coders' pictures re-framed as fields), the
    second slice of the IDR field (k 1: spatial concealment) or of the
    bottom field of frame 0 (k 4: inter concealment from the top field)
    dropped; its MBs concealed in the field, the frames equal."""
    cf, bd = VARIANTS[variant]
    data = host_fields(4, 48, 64, 28, cf, slice_mode=1, slice_argument=2)
    if bd > 8:
        data = reheaded(data, 110, bd)
    units = list(split_annexb(data))
    vcl = _vcl(units)
    assert len(vcl) == 12
    dec, out, _, _ = _decode_both(
        _join([u for i, u in enumerate(units) if i != vcl[k]]), mode)
    assert len(out) == 2 and dec.concealed_count == 2


def test_strict_mode(streams):
    """conceal_mode 0: a frame_num gap goes unnoticed (a frame short, as
    in jm_tpu), a dropped slice raises ValueError."""
    s = streams("8")
    out = H264Decoder(device="cpu").decode_annexb(s["lost_p"])
    assert len(out) == len(JaxDecoder().decode_annexb(s["lost_p"])) == 5
    with pytest.raises(ValueError, match="slice data missing"):
        H264Decoder(device="cpu").decode_annexb(s["lost_p_slice"])
    with pytest.raises(ValueError):
        H264Decoder(conceal_mode=3)


# ---- jm_tpu's faults, copied --------------------------------------------

@pytest.mark.parametrize("variant", ["10", "422_10"])
def test_motion_copy_clips_at_255_and_writes_422_chroma_as_420(
        variant, one_torch_thread):
    """jm_tpu conceal.py _motion_copy (:77-89) clips its predictions at
    255 and casts the frame to uint8 (the samples it copies wrap mod
    256), and at 4:2:2 writes the chroma with 4:2:0 geometry: rows
    py / 2, so only the upper half of each chroma plane is predicted, the
    lower half staying the source's. An IPPPPP stream with two reference
    frames (so that the source's own reference is still in the DPB) and
    its second P picture (POC 4) lost, mode 2: the concealed frame
    replays the motion of the frame of POC 2, the port's equal to
    jm_tpu's."""
    units = _encode(6, variant=variant, num_ref=2)
    _, out, _, want = _decode_both(_join(units[:4] + units[5:]), 2)
    k = [f.poc for f in out].index(4)
    lost, src = out[k], out[k - 1]
    assert src.poc == 2 and want[k].Y.dtype == np.uint8
    # predicted samples clipped at 255 where the source's exceed it
    assert int(lost.Y.max()) == 255 < int(src.Y.max())
    assert int((lost.Y == 255).sum()) > int((src.Y & 255 == 255).sum())
    h = lost.U.shape[0]
    if variant == "422_10":
        assert h == 48
        for p in "UV":
            a, b = getattr(lost, p), getattr(src, p)
            assert np.array_equal(a[h // 2:], b[h // 2:] & 255)
            assert not np.array_equal(a[:h // 2], b[:h // 2] & 255)


def _planes10(rng, mb_w, mb_h, crows):
    """Smooth 10-bit planes with samples above 255: (Y, U, V) uint16."""
    out = []
    for h, w in ((16 * mb_h, 16 * mb_w), (4 * crows * mb_h, 8 * mb_w)):
        yy, xx = np.mgrid[0:h, 0:w]
        out.append((512 + 300 * np.sin(xx / 5.0) * np.cos(yy / 6.0)
                    + rng.integers(0, 8, (h, w))).astype(np.uint16))
    Y, U = out
    return Y, U, (1023 - U).astype(np.uint16)


@pytest.mark.parametrize("crows", [2, 4])
def test_spatial_conceal_clips_at_255_and_fills_8x8_chroma(crows):
    """jm_tpu conceal.py _conceal_spatial_mb (:132-162) casts its
    weighted average to uint8 after a clip at 255, and conceal_mbs
    (:124-126) conceals 8 x 8 chroma blocks at 4:2:2 too (rows 8 mby):
    on 10-bit planes with lost MBs and no reference, the port's
    conceal_mbs equals jm_tpu's, the concealed samples are at most 255
    and a 4:2:2 MB's chroma rows 8 mby + 8 .. 16 mby + 16 stay as they
    were."""
    rng = np.random.default_rng(crows)
    mb_w, mb_h = 4, 3
    Y, U, V = _planes10(rng, mb_w, mb_h, crows)
    lost = np.zeros(mb_w * mb_h, bool)
    lost[[5, 6, 9]] = True
    cf = 1 if crows == 2 else 2
    got, want = [p.copy() for p in (Y, U, V)], [p.copy() for p in (Y, U, V)]
    n = conceal.conceal_mbs(*got, PictureData(mb_w, mb_h, cf), lost, None,
                            mb_w, mb_h)
    assert n == jm_conceal.conceal_mbs(*want, JPictureData(mb_w, mb_h, cf),
                                       lost, None, mb_w, mb_h) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert int(got[0][16:32, 16:48].max()) <= 255 < int(Y.max())
    assert int(got[1][8:16, 8:24].max()) <= 255
    if crows == 4:
        # MB (1, 1)'s second chroma half, rows 24..31, untouched
        assert np.array_equal(got[1][24:32, 8:16], U[24:32, 8:16])


@pytest.mark.parametrize("crows", [2, 4])
def test_inter_conceal_casts_mc_blocks_to_uint8(crows):
    """jm_tpu conceal.py _conceal_inter_mb (:214-228) casts each 16 x 16
    luma and each chroma MC block to uint8: at 10 bits the concealed
    samples are the reference's mod 256. Lost MBs beside inter MBs with
    motion, a 10-bit reference (the port's HostRef of its prep_ref state
    against jm_tpu's Frame of bit_depth 10): the planes and the picture's
    MVs equal, the concealed luma the MC block of the chosen MV mod 256,
    the 4:2:2 chroma 16 rows a MB."""
    rng = np.random.default_rng(10 + crows)
    mb_w, mb_h = 4, 3
    cf = 1 if crows == 2 else 2
    Y, U, V = _planes10(rng, mb_w, mb_h, crows)
    rY, rU, rV = _planes10(rng, mb_w, mb_h, crows)
    pic, jpic = PictureData(mb_w, mb_h, cf), JPictureData(mb_w, mb_h, cf)
    mv = rng.integers(-9, 10, (mb_w * mb_h, 16, 2)).astype(np.int32)
    lost = np.zeros(mb_w * mb_h, bool)
    lost[[5, 6]] = True
    for p in (pic, jpic):
        p.mv[:] = mv
        p.ref_idx[:] = 0
        p.mb_class[:] = 0
    ref = conceal.HostRef(prep_ref(*(torch.as_tensor(p.view(np.int16))
                                     for p in (rY, rU, rV)), 10))
    jref = JFrame(poc=0, frame_num=0, Y=rY, U=rU, V=rV, bit_depth=10)
    got, want = [p.copy() for p in (Y, U, V)], [p.copy() for p in (Y, U, V)]
    conceal.conceal_mbs(*got, pic, lost, ref, mb_w, mb_h)
    jm_conceal.conceal_mbs(*want, jpic, lost, jref, mb_w, mb_h)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(pic.mv, jpic.mv)
    for addr in (5, 6):
        y, x = divmod(addr, mb_w)
        mvx, mvy = (int(v) for v in pic.mv[addr, 0])
        blk = jm_interp.mc_luma_block(jref.luma_planes, x * 64 + mvx,
                                      y * 64 + mvy, 16, 16, 16 * mb_w,
                                      16 * mb_h)
        assert blk.max() > 255
        assert np.array_equal(got[0][16 * y:16 * y + 16, 16 * x:16 * x + 16],
                              blk & 255)
    ch = 4 * crows
    assert not np.array_equal(got[1][ch:2 * ch, 8:24], U[ch:2 * ch, 8:24])


def test_concealed_frame_is_an_8_bit_reference():
    """jm_tpu conceal.py conceal_lost_frame (:41) builds the concealed
    Frame without its bit depth (8): as a reference its half samples clip
    at 255 and its integer plane wraps mod 256 (interp.make_luma_planes'
    uint8 cast), its chroma padded as it is. conceal.concealed_state of
    10-bit planes equals that Frame's luma_planes and chroma_pad, and the
    frame's own samples (Frame.planes) stay 10-bit."""
    rng = np.random.default_rng(3)
    Y, U, V = _planes10(rng, 3, 2, 2)
    state = conceal.concealed_state(*(torch.as_tensor(p.view(np.int16))
                                      for p in (Y, U, V)))
    jf = JFrame(poc=0, frame_num=0, Y=Y, U=U, V=V)
    assert jf.bit_depth == 8
    for k in range(4):
        assert np.array_equal(state[0][k].numpy(), jf.luma_planes[k])
    assert np.array_equal(state[0][0].numpy()[PAD:-PAD, PAD:-PAD], Y & 255)
    for got, want in zip(state[1:], jf.chroma_pad):
        assert np.array_equal(got.numpy(), want)
