"""Shared cases of the stream tests of the port's encoder
(tests/test_torch_encoder.py for device_rd=True, test_torch_fallback.py
for md_low): clips of tests/test_pipe_stream.py at 96x80, QP 30, encoded
by jm_tpu's Encoder(pipeline="device") and by the port on the CPU, and
the checks that hold them equal; the same for a configuration encoded
frame by frame through both encoders' host coders (the host pipeline
and High-profile tests); the fade of the weighted prediction tests;
and the clip of blockwise motion of the motion-option tests, with their
run of a configuration through both encoders (``option_run``)."""

import numpy as np
import pytest
import torch

from jm_tpu.decoder.decoder import H264Decoder as JaxDecoder
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.decoder.decoder import H264Decoder
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig

from test_pipe_stream import make_frames

W, H, QP = 96, 80, 30
# clip: (frames, intra_period, noise_at); the scene cuts replace frame 2
# by noise, so the pipe's intra speculation fails on frames 2 and 3 (3
# is predicted from the noise)
CLIPS = {"ippp": (5, 0, None), "idr_every_3": (6, 3, None),
         "cut4": (4, 0, 2), "cut5": (5, 0, 2)}
CUT_FALLBACKS = [2, 3]


def clip_frames(clip):
    n, _ip, noise_at = CLIPS[clip]
    return make_frames(W, H, n, noise_at=noise_at)


def jax_encoder(rd: bool, clip="ippp", **kw):
    return JaxEncoder(JaxConfig(width=W, height=H, qp=QP, pipeline="device",
                                intra_period=CLIPS[clip][1], device_rd=rd,
                                **kw))


def port_encoder(rd: bool, clip="ippp", **kw):
    return Encoder(EncoderConfig(width=W, height=H, qp=QP, device_rd=rd,
                                 intra_period=CLIPS[clip][1], **kw),
                   device="cpu")


def runs(rd: bool):
    """Per clip: (frames, jm_tpu payloads, jm_tpu results, port encoder,
    port payloads)."""
    out = {}
    for clip in CLIPS:
        frames = clip_frames(clip)
        jenc = jax_encoder(rd, clip)
        want = jenc.encode_stream(frames)
        enc = port_encoder(rd, clip)
        out[clip] = (frames, want, jenc.results, enc,
                     enc.encode_stream(frames))
    return out


def same_recon(a_results, b_results):
    assert [r["type"] for r in a_results] == [r["type"] for r in b_results]
    for a, b in zip(a_results, b_results):
        for plane in "YUV":
            assert np.array_equal(getattr(a["frame"], plane),
                                  getattr(b["frame"], plane))


def check_byte_identical(run):
    frames, want, want_res, enc, got = run
    assert len(got) == len(want) == len(frames)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {i} payload differs"
    same_recon(enc.results, want_res)


def check_fallbacks(run, clip):
    """Which frames fell back to the per-frame path, with intra MBs
    re-encoded, and how many dispatches were repeated: the frame after
    each fallback, where there is one. No packer overflows here."""
    frames, _, _, enc, _ = run
    want = CUT_FALLBACKS if CLIPS[clip][2] is not None else []
    assert enc.fallbacks == want and enc.ovf == []
    assert enc.redispatches == sum(d + 1 < len(frames) for d in want)
    for r in enc.results:
        if r["disp"] in want:
            assert 0 < r["intra_mbs"] <= (W // 16) * (H // 16)
        else:
            assert "intra_mbs" not in r


def check_decodes(run):
    """The stream decodes with the port's H264Decoder(device="cpu") and
    with jm_tpu's H264Decoder to the port's recon, picture by picture in
    decode order (the order of ``results``)."""
    _, _, _, enc, got = run
    data = b"".join(got)
    for dec in (H264Decoder(device="cpu"), JaxDecoder()):
        out = dec.decode_annexb(data)
        assert len(out) == len(enc.results)
        for frame, res in zip(out, enc.results):
            for plane in "YUV":
                assert np.array_equal(getattr(frame, plane),
                                      getattr(res["frame"], plane))


def check_intra_refresh(rd: bool):
    """intra_mb_refresh=6: every frame on the per-frame path, six forced
    MBs per P frame at least."""
    frames = make_frames(W, H, 5, seed=4)
    want = jax_encoder(rd, intra_mb_refresh=6).encode_stream(frames)
    enc = port_encoder(rd, intra_mb_refresh=6)
    assert enc.encode_stream(frames) == want
    assert all(r["intra_mbs"] >= 6 for r in enc.results[1:])
    assert enc.fallbacks == [] and enc.redispatches == 0


def fade(frames, step: float = 0.08):
    """A fade to black of (Y, U, V) frames: frame k's luma scaled by
    1 - step k, its chroma pulled toward 128 by the same factor (the
    content weighted prediction is for)."""
    out = []
    for k, (Y, U, V) in enumerate(frames):
        f = 1.0 - step * k
        out.append(tuple(
            np.clip(c + (p.astype(np.float64) - c) * f, 0, 255)
            .astype(np.uint8) for p, c in ((Y, 0.0), (U, 128.0),
                                           (V, 128.0))))
    return out


def frame_run(cfg: dict, n: int, pipeline: str = "host"):
    """The 96x80 QP 30 clip's first n frames encoded through encode_frame
    and flush by jm_tpu's Encoder and by the port's with the same
    EncoderConfig keywords cfg and pipeline (option_run): (jm_tpu
    payloads, jm_tpu results, port encoder, port payloads)."""
    _frames, want, results, enc, got = option_run(
        cfg, make_frames(W, H, n), pipeline)
    return want, results, enc, got


def check_frame_run_payloads(run):
    want, _, _, got = run
    assert [len(p) for p in got] == [len(p) for p in want]
    assert got == want


def check_frame_run_recon(run):
    _, want, enc, _ = run
    assert [(r["disp"], r["type"]) for r in enc.results] == \
        [(r["disp"], r["type"]) for r in want]
    same_recon(enc.results, want)


def check_frame_run_decodes(run):
    """The port's decode of the stream equals the recon (POC counts from
    the clip's only IDR, frame 0)."""
    _, _, enc, got = run
    out = H264Decoder(device="cpu").decode_annexb(b"".join(got))
    by_disp = {r["disp"]: r["frame"] for r in enc.results}
    assert sorted(f.poc // 2 for f in out) == sorted(by_disp)
    for f in out:
        for p in "YUV":
            assert np.array_equal(getattr(f, p),
                                  getattr(by_disp[f.poc // 2], p))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The host coders' and the CPU decode's tensor steps are small: more
    threads only slow them down (a 96x80 host-pipeline case takes 1.4x
    as long with 8 threads as with 1), the more so beside other test
    workers. Imported by the test modules that use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def motion_clip(n: int, w: int = W, h: int = H, seed: int = 3):
    """n frames of seeded smoothed noise in which every 4x4 block moves
    with its 8x8 block's velocity, a quarter of them with an offset of
    their own, and frame 3 repeats frame 1: content on which the host P
    coder chooses sub-8x8 partitions and, with several references, the
    older one."""
    rng = np.random.default_rng(seed)
    pad = 24
    base = rng.integers(0, 256, (h + 2 * pad + 8 * n,
                                 w + 2 * pad + 8 * n)).astype(np.float64)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = np.clip((base - 128) * 3 + 128, 0, 255)
    vel = np.repeat(np.repeat(rng.integers(-1, 2, (h // 8, w // 8, 2)), 2,
                              axis=0), 2, axis=1)
    vel = vel + rng.integers(-1, 2, vel.shape) * (
        rng.random(vel.shape[:2]) < 0.25)[..., None]
    out = []
    for t in [0, 1, 2, 1, 3, 4, 5, 6][:n]:
        Y = np.empty((h, w))
        for by in range(h // 4):
            for bx in range(w // 4):
                vy, vx = vel[by, bx]
                y0 = pad + by * 4 + t * (1 + vy)
                x0 = pad + bx * 4 + t * (2 + vx)
                Y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
                    base[y0:y0 + 4, x0:x0 + 4]
        Y = Y.astype(np.uint8)
        out.append((Y, (Y[::2, ::2] // 2 + 64).astype(np.uint8),
                    (Y[1::2, 1::2] // 3 + 90).astype(np.uint8)))
    return out


def option_run(cfg: dict, frames, pipeline: str = "host",
               stream: bool = False):
    """frames encoded at their size, QP 30, by jm_tpu's Encoder and by the
    port's with the same EncoderConfig keywords cfg and pipeline, through
    encode_frame and flush (stream: encode_stream, then flush), shaped as
    runs(): (frames, jm_tpu payloads, jm_tpu results, port encoder, port
    payloads), a final flush's payload appended to the last."""
    h, w = frames[0][0].shape
    jenc = JaxEncoder(JaxConfig(width=w, height=h, qp=QP, pipeline=pipeline,
                                **cfg))
    enc = Encoder(EncoderConfig(width=w, height=h, qp=QP, pipeline=pipeline,
                                **cfg), device="cpu")
    out = []
    for e in (jenc, enc):
        pay = e.encode_stream(frames) if stream else \
            [e.encode_frame(*f) for f in frames]
        pay[-1] += e.flush()
        out.append(pay)
    return frames, out[0], jenc.results, enc, out[1]



def reheaded(data: bytes, profile: int, bit_depth: int = 8,
             bypass: int = 0, init_qp_shift: int = 0) -> bytes:
    """The stream with each SPS written again by the port's write_sps at
    profile 100 (122 at 4:2:2) with bit_depth_luma / chroma_minus8 =
    bit_depth - 8 and qpprime_y_zero_transform_bypass_flag = bypass, its
    profile_idc byte then set to ``profile`` (110 High 10, 244 High 4:4:4
    Predictive: at 4:2:0 their SPS layout is High's); with init_qp_shift,
    each PPS's pic_init_qp_minus26 moved by it (every slice QP with it,
    below 0 above 8 bits). The slices stay as they are: a valid stream
    whose pictures the spec fixes (chip_smoke.py reheaded, phase 41)."""
    from jm_tpu_torch.bitstream.nal import (NalUnitType, annexb_bytes,
                                            split_annexb)
    from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
    from jm_tpu_torch.encoder.syntax import write_pps, write_sps
    out, sps_map = [], {}
    for nal in split_annexb(data):
        rbsp = nal.rbsp
        if nal.nal_unit_type == NalUnitType.SPS:
            sps = parse_sps(rbsp)
            sps_map[sps.seq_parameter_set_id] = sps
            sps.profile_idc = 122 if sps.chroma_format_idc == 2 else 100
            sps.bit_depth_luma_minus8 = bit_depth - 8
            sps.bit_depth_chroma_minus8 = bit_depth - 8
            sps.qpprime_y_zero_transform_bypass_flag = bypass
            rbsp = bytes([profile]) + write_sps(sps)[1:]
        elif nal.nal_unit_type == NalUnitType.PPS and init_qp_shift:
            pps = parse_pps(rbsp, sps_map)
            pps.pic_init_qp_minus26 += init_qp_shift
            rbsp = write_pps(pps)
        out.append(annexb_bytes(nal.nal_ref_idc, nal.nal_unit_type, rbsp))
    return b"".join(out)


def rewritten_slice(nal, sps_map: dict, pps_map: dict, sps=None,
                    **header) -> bytes:
    """The RBSP of slice NAL unit ``nal`` with its header written again by
    the port's write_slice_header with the keywords ``header`` changed,
    under ``sps`` if given (else the one it was parsed with), its slice
    data kept bit for bit; sps_map / pps_map: the parameter sets that the
    old header is parsed with."""
    from jm_tpu_torch.bitstream.bitwriter import BitWriter
    from jm_tpu_torch.decoder.header import parse_slice_header
    from jm_tpu_torch.encoder.syntax import write_slice_header
    h, br = parse_slice_header(nal, sps_map, pps_map)
    p = pps_map[h.pic_parameter_set_id]
    kw = dict(slice_type=h.slice_type, frame_num=h.frame_num,
              idr=h.is_idr, idr_pic_id=h.idr_pic_id, qp=h.qp(p),
              first_mb=h.first_mb_in_slice, poc_lsb=h.pic_order_cnt_lsb,
              num_ref_idx_l0=h.num_ref_idx_l0_active_minus1 + 1,
              field_pic=h.field_pic_flag, bottom_field=h.bottom_field_flag)
    kw.update(header)
    bw = BitWriter()
    write_slice_header(bw, sps or sps_map[p.seq_parameter_set_id], p, **kw)
    bits = np.unpackbits(np.frombuffer(nal.rbsp, np.uint8))
    stop = len(bits) - 1 - int(np.argmax(bits[::-1]))
    rest = bits[br.pos:stop]
    bw.append_bitstream(np.packbits(rest).tobytes(), len(rest))
    bw.rbsp_trailing_bits()
    return bw.get_bytes()


def reframed_fields(data: bytes) -> bytes:
    """A PAFF stream made of a stream of frame pictures: its SPS written
    again with frame_mbs_only_flag 0, mb_adaptive_frame_field_flag 0 and
    direct_8x8_inference_flag 1 (pic_height_in_map_units_minus1 kept, so
    that each W x H/2 picture becomes one field of a W x H frame), and
    the slice headers of its k-th picture written again as a field's (top
    for even k, bottom for odd), frame_num k // 2, pic_order_cnt_lsb k,
    one active reference; the slice data kept bit for bit. The port's
    field coder is 4:2:0 only, as jm_tpu's: 4:2:2 field streams are made
    so from its 4:2:2 frame coders (an IDR, then P pictures: the bottom
    field of frame 0 predicts from its top field, of the other parity)."""
    from jm_tpu_torch.bitstream.nal import (NalUnitType, annexb_bytes,
                                            split_annexb)
    from jm_tpu_torch.decoder.header import parse_slice_header
    from jm_tpu_torch.decoder.parset import parse_pps, parse_sps
    from jm_tpu_torch.encoder.syntax import write_sps
    out, sps_map, pps_map, fields = [], {}, {}, {}
    k, last = -1, None
    for nal in split_annexb(data):
        rbsp = nal.rbsp
        t = nal.nal_unit_type
        if t == NalUnitType.SPS:
            s = parse_sps(rbsp)
            sps_map[s.seq_parameter_set_id] = s
            f = parse_sps(rbsp)
            f.frame_mbs_only_flag = 0
            f.mb_adaptive_frame_field_flag = 0
            f.direct_8x8_inference_flag = 1
            fields[f.seq_parameter_set_id] = f
            rbsp = write_sps(f)
        elif t == NalUnitType.PPS:
            p = parse_pps(rbsp, sps_map)
            pps_map[p.pic_parameter_set_id] = p
        elif t in (NalUnitType.SLICE, NalUnitType.IDR):
            h, _ = parse_slice_header(nal, sps_map, pps_map)
            key = (h.frame_num, h.pic_order_cnt_lsb, h.is_idr)
            if key != last:
                k, last = k + 1, key
            p = pps_map[h.pic_parameter_set_id]
            rbsp = rewritten_slice(
                nal, sps_map, pps_map, sps=fields[p.seq_parameter_set_id],
                field_pic=1, bottom_field=k % 2, frame_num=k // 2,
                poc_lsb=k, num_ref_idx_l0=1)
        out.append(annexb_bytes(nal.nal_ref_idc, t, rbsp))
    return b"".join(out)


def field_stream(n: int = 2, w: int = 32, h: int = 32, qp: int = QP) -> bytes:
    """The port encoder's PAFF stream of n frames of motion_clip at w x h
    (pic_interlace 1: an IDR top field, then P fields; 4:2:0, 8 bits, as
    its field coder and jm_tpu's are)."""
    enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, pic_interlace=1),
                  device="cpu")
    return b"".join(enc.encode_frame(*f) for f in motion_clip(n, w, h))


def host_fields(n: int = 4, w: int = 32, h: int = 32, qp: int = QP,
                chroma_format: int = 2, **kw) -> bytes:
    """A PAFF stream of n / 2 frames of w x h: n pictures of motion_clip
    at w x h / 2 (their chroma rows doubled at 4:2:2) coded by the port's
    host coders (an IDR, then P pictures; EncoderConfig keywords kw, e.g.
    slices) and re-framed as fields (reframed_fields)."""
    frames = motion_clip(n, w, h // 2)
    if chroma_format == 2:
        frames = [(Y, np.repeat(U, 2, axis=0), np.repeat(V, 2, axis=0))
                  for Y, U, V in frames]
    enc = Encoder(EncoderConfig(width=w, height=h // 2, qp=qp,
                                chroma_format=chroma_format,
                                pipeline="host", **kw), device="cpu")
    return reframed_fields(b"".join(enc.encode_frame(*f) for f in frames))
