"""I_PCM in the port against jm_tpu, on the CPU, exactly: the CAVLC
MBWriter's I_PCM branch and the CABAC writer's _write_ipcm (escape bins,
terminate(1), aligned samples, the engine restarted) write jm_tpu's
bytes for I_PCM MBs patched into the I, P and B slices of a host-coded
stream, and both decoders parse them back (the native CAVLC parser
handing the slice to the Python one); and the deblocking QP of an
I_PCM MB, which both packages take from the slice QP where H.264 8.7.2.2
gives qPp = 0 (a suspected reference fault, kept for byte parity):
the edges with bS > 0 on I_PCM MBs are counted, and the samples the
spec's rule would deblock otherwise."""

import copy

import numpy as np
import pytest
import torch

import torch_streams as S
from jm_tpu.decoder import decoder as jm_decoder
from jm_tpu.encoder import syntax as jm_syntax
from jm_tpu.encoder import syntax_cabac as jm_syntax_cabac
from jm_tpu_torch import native as N
from jm_tpu_torch.bitstream.nal import annexb_bytes, split_annexb
from jm_tpu_torch.common.picture import MB_IPCM
from jm_tpu_torch.decoder import decoder as port_decoder
from jm_tpu_torch.encoder import encoder as port_encoder
from jm_tpu_torch.ops.deblock import compute_bs
from test_pipe_stream import make_frames

SLICES = ("I", "P", "B")
# the MBs of a 64x48 picture made I_PCM: a corner, an inner MB, the last
PCM_MBS = (0, 5, 11)


def _capture(entropy: str):
    """The port's host-pipeline stream of 3 frames at 64x48 with num_b=1
    (I0 P2 B1), and each slice's PictureData and serializer keywords as
    they reached the serializer."""
    name = "serialize_slice_cabac" if entropy == "cabac" \
        else "serialize_slice"
    orig = getattr(port_encoder, name)
    seen = []

    def spy(pic, sps, pps, **kw):
        seen.append((copy.deepcopy(pic), sps, pps, dict(kw)))
        return orig(pic, sps, pps, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_encoder, name, spy)
    try:
        enc = S.Encoder(S.EncoderConfig(width=64, height=48, qp=30,
                                        pipeline="host", num_b=1,
                                        entropy=entropy), device="cpu")
        data = b"".join(enc.encode_frame(*f)
                        for f in make_frames(64, 48, 3, seed=2))
        data += enc.flush()
    finally:
        mp.undo()
    assert [k["slice_type"].name for _p, _s, _q, k in seen] == list("IPB")
    return data, seen


@pytest.fixture(scope="module")
def captures():
    return {e: _capture(e) for e in ("cavlc", "cabac")}


def _to_ipcm(pic, seed: int):
    """A copy of pic with PCM_MBS made I_PCM with seeded samples 1..255."""
    pic = copy.deepcopy(pic)
    rng = np.random.default_rng(seed)
    for a in PCM_MBS:
        pic.mb_class[a] = MB_IPCM
        pic.skip[a] = pic.b_direct[a] = pic.transform8x8[a] = False
        pic.cbp[a] = 0
        pic.luma_nnz[a] = 16
        pic.chroma_nnz[a] = 16
        pic.ref_idx[a] = pic.ref_idx_l1[a] = pic.pdir[a] = -1
        pic.mv[a] = pic.mv_l1[a] = 0
        pic.ipcm_luma[a] = rng.integers(1, 256, (16, 16), np.uint8)
        pic.ipcm_chroma[a] = rng.integers(1, 256, (2, 8, 8), np.uint8)
    return pic


class _PortCapture(port_decoder.H264Decoder):
    def __init__(self):
        super().__init__(device="cpu")
        self.pics = []

    def _finish_picture(self):
        if self._cur is not None:
            self.pics.append(self._cur["pic"])
        super()._finish_picture()


class _JmCapture(jm_decoder.H264Decoder):
    def __init__(self):
        super().__init__()
        self.pics = []

    def _finish_picture(self):
        if self._cur is not None:
            self.pics.append(self._cur["pic"])
        super()._finish_picture()


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("kind", SLICES)
def test_ipcm_writer_matches_jm_and_parses(captures, entropy, kind):
    """The slice of kind with PCM_MBS made I_PCM: the port's serializer
    (CAVLC through the Python MBWriter, counted) writes jm_tpu's RBSP;
    the stream with that slice in its place parses, in both decoders, to
    the I_PCM MBs and samples written and to the other MBs as coded (the
    port's CAVLC I and P slices: the native parser stops at the first
    I_PCM MB and the Python parser reads the slice)."""
    data, seen = captures[entropy]
    k = SLICES.index(kind)
    pic, sps, pps, kw = seen[k]
    ipcm = _to_ipcm(pic, seed=k)
    N.reset_routes()
    if entropy == "cabac":
        ours = port_encoder.serialize_slice_cabac(ipcm, sps, pps, **kw)
        theirs = jm_syntax_cabac.serialize_slice_cabac(
            copy.deepcopy(ipcm), sps, pps, **kw)
    else:
        ours = port_encoder.serialize_slice(ipcm, sps, pps, **kw)
        theirs = jm_syntax.serialize_slice(copy.deepcopy(ipcm), sps, pps,
                                           **kw)
        route = "b" if kind == "B" else "serialize"
        if kind != "B":
            assert N.routes[route] == {"native": 0, "python": 1}
    assert ours == theirs
    units = split_annexb(data)
    slices = [i for i, u in enumerate(units) if u.nal_unit_type in (1, 5)]
    units[slices[k]].rbsp = ours
    stream = b"".join(annexb_bytes(u.nal_ref_idc, u.nal_unit_type, u.rbsp)
                      for u in units)
    N.reset_routes()
    port = _PortCapture()
    port.decode_annexb(stream)
    if entropy == "cavlc" and kind != "B":
        assert N.routes["parse"]["rerun"] == 1
    jm = _JmCapture()
    jm.decode_annexb(stream)
    for dec in (port, jm):
        got = dec.pics[k]
        assert np.array_equal(got.mb_class, ipcm.mb_class)
        for a in PCM_MBS:
            assert np.array_equal(got.ipcm_luma[a], ipcm.ipcm_luma[a])
            assert np.array_equal(got.ipcm_chroma[a], ipcm.ipcm_chroma[a])
        keep = np.setdiff1d(np.arange(ipcm.n_mbs), PCM_MBS)
        for name in ("skip", "cbp", "luma_coef", "chroma_dc"):
            assert np.array_equal(getattr(got, name)[keep],
                                  getattr(ipcm, name)[keep]), name
        # coded motion (a skipped or direct MB's is derived from its
        # neighbours, some of them I_PCM now)
        coded = keep[~(ipcm.skip[keep] | ipcm.b_direct[keep])]
        assert np.array_equal(got.mv[coded], ipcm.mv[coded])


def noise_patch(frames, seed: int = 9, at: int = 16, size: int = 32):
    """frames with a seeded uniform-noise size x size luma patch (chroma
    alike) at (at, at), a new one in each frame: I_PCM or Intra4x4 wins
    its MBs, in I and in P pictures."""
    rng = np.random.default_rng(seed)
    out = []
    c0, c1 = at // 2, (at + size) // 2
    for Y, U, V in frames:
        y = rng.integers(0, 256, (size, size), np.uint8)
        c = rng.integers(0, 256, (2, size // 2, size // 2), np.uint8)
        Y, U, V = Y.copy(), U.copy(), V.copy()
        Y[at:at + size, at:at + size] = y
        U[c0:c1, c0:c1] = c[0]
        V[c0:c1, c0:c1] = c[1]
        out.append((Y, U, V))
    return out


# case -> (QP, config, noise patch, I_PCM MBs per picture)
# (edges with bS > 0 on I_PCM MBs, samples qPp = 0 would deblock otherwise)
DEBLOCK_COUNTS = {"rd_qp12": (272, 0), "forced_qp30": (712, 2591)}
DEBLOCK_CASES = {"rd_qp12": (12, dict(enable_ipcm=1, rdo=1), True, [4, 4]),
                 "forced_qp30": (30, dict(enable_ipcm=2), False, [12, 12])}


@pytest.mark.parametrize("case", list(DEBLOCK_CASES))
def test_ipcm_deblock_qp_is_the_slice_qp(case):
    """I_PCM MBs (64x48, I + P) chosen by RD at QP 12 on a clip with a
    noise patch, or forced at QP 30: both decoders give them the slice QP
    as jm_tpu's encoder does (bytes, recon and decodes equal). Counted:
    the edges with bS > 0 on I_PCM MBs, where 8.7.2.2's qPp = 0 would
    change the filter's QP, and the samples the spec's rule would deblock
    otherwise: none at QP 12 (both rules' indexA stay below 16, where
    the filter is off), many at QP 30."""
    qp, kw, patch, n_pcm = DEBLOCK_CASES[case]
    frames = make_frames(64, 48, 2, seed=1)
    if patch:
        frames = noise_patch(frames)
    seen = []
    mp = pytest.MonkeyPatch()
    lf = port_encoder.Encoder._loop_filter

    def spy(self, rec, pic):
        seen.append((tuple(np.array(p) for p in rec), copy.deepcopy(pic)))
        return lf(self, rec, pic)

    mp.setattr(port_encoder.Encoder, "_loop_filter", spy)
    cfg = dict(width=64, height=48, qp=qp, **kw)
    try:
        enc = S.Encoder(S.EncoderConfig(pipeline="host", **cfg),
                        device="cpu")
        got = [enc.encode_frame(*f) for f in frames]
    finally:
        mp.undo()
    jenc = S.JaxEncoder(S.JaxConfig(**cfg))
    assert got == [jenc.encode_frame(*f) for f in frames]
    run = (frames, got, jenc.results, enc, got)
    S.check_byte_identical(run)
    S.check_decodes(run)
    assert [int((p.mb_class == MB_IPCM).sum()) for _r, p in seen] == n_pcm
    edges = samples = 0
    for rec, pic in seen:
        pcm = pic.mb_class == MB_IPCM
        assert (pic.qp[pcm] == qp).all()
        t = [torch.as_tensor(np.ascontiguousarray(a)) for a in (
            pic.mb_class, pic.luma_nnz, pic.transform8x8.astype(np.int32),
            pic.mv, pic.mv_l1, pic.ref_pic_id, pic.ref_pic_id_l1)]
        bs_v, bs_h = (b.numpy() for b in compute_bs(*t, pic.mb_w, pic.mb_h))
        blk = np.kron(pcm.reshape(pic.mb_h, pic.mb_w),
                      np.ones((4, 4), bool))
        edges += int(((bs_v > 0) & (blk | np.roll(blk, 1, axis=1))).sum()
                     + ((bs_h > 0) & (blk | np.roll(blk, 1, axis=0))).sum())
        spec = copy.deepcopy(pic)
        spec.qp[pcm] = 0
        a, b = enc._deblock(rec, pic), enc._deblock(rec, spec)
        samples += sum(int((x != y).sum()) for x, y in zip(a, b))
    assert (edges, samples) == DEBLOCK_COUNTS[case]
    # the decoders keep the slice QP on I_PCM MBs
    for dec in (_PortCapture(), _JmCapture()):
        dec.decode_annexb(b"".join(got))
        for pic in dec.pics:
            assert (pic.qp[pic.mb_class == MB_IPCM] == qp).all()
