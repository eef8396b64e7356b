"""The port's tensor CAVLC packer (jm_tpu_torch/ops/cavlc.py) against
jm_tpu's cavlc_jax, exactly: block_slots, fold_slots (32-bit words kept
as int64 masked to 32 bits), assemble (empty pieces dropped through a
spare scatter slot, searchsorted ties), and pack_p_slice_full including
an overflow forced by a small word budget; and the packed slice against
the port's host serializer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jm_tpu.ops import cavlc_jax as CJ
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.common.picture import MB_INTER, PictureData
from jm_tpu_torch.common.types import PPS, SPS, SliceType
from jm_tpu_torch.encoder.syntax import serialize_slice, write_slice_header
from jm_tpu_torch.ops import cavlc as CV

from test_cavlc_jax import random_fast_pic

FIELDS = ("inter_mode", "mv", "cbp", "luma_coef", "luma_nnz", "chroma_dc",
          "chroma_coef", "chroma_nnz")


def _fields(pic):
    return [np.ascontiguousarray(getattr(pic, k), np.int32) for k in FIELDS]


def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("max_coeff,nc_vals,max_lvl", [
    (16, (0, 1, 2, 3, 4, 7, 8, 12), 4),
    (16, (0, 3, 9), 3000),              # escape codes and overflow
    (15, (0, 2, 5, 10), 20),
    (4, (-1,), 40),
])
def test_block_slots_match_jax(max_coeff, nc_vals, max_lvl):
    rng = np.random.default_rng(max_coeff + max_lvl)
    B = 600
    c = rng.integers(-max_lvl, max_lvl + 1, (B, max_coeff))
    c *= rng.random((B, max_coeff)) < rng.random((B, 1))
    c[: B // 4] = np.clip(c[: B // 4], -1, 1)          # trailing ones
    c = c.astype(np.int32)
    nc = rng.choice(nc_vals, B).astype(np.int32)
    jv, jl, jo = CJ.block_slots(jnp.asarray(c), jnp.asarray(nc), max_coeff)
    tv, tl, to = CV.block_slots(torch.from_numpy(c), torch.from_numpy(nc),
                                max_coeff)
    assert np.array_equal(_u32(jv), tv.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert np.array_equal(np.asarray(jo), to.numpy())
    jw, jb = CJ.fold_slots(jv, jl, CV.BLOCK_WORDS)
    tw, tb = CV.fold_slots(tv, tl, CV.BLOCK_WORDS)
    assert tw.dtype == torch.int64 and int(tw.max()) < 2 ** 32
    assert np.array_equal(_u32(jw), tw.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())


def test_fold_slots_words_straddle_boundaries():
    """Slots of 1..32 bits with all-ones values cross every word boundary;
    int64 words masked to 32 bits must equal the uint32 fold."""
    rng = np.random.default_rng(5)
    B, S = 64, 30
    lens = rng.integers(0, 33, (B, S)).astype(np.int32)
    vals = ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)) \
        .astype(np.uint32)
    vals[:, ::3] = rng.integers(0, 2 ** 32, (B, len(range(0, S, 3))),
                                dtype=np.uint64).astype(np.uint32) \
        & ((np.uint64(1) << lens[:, ::3].astype(np.uint64)) - np.uint64(1)) \
        .astype(np.uint32)
    jw, jb = CJ.fold_slots(jnp.asarray(vals), jnp.asarray(lens), 32)
    tw, tb = CV.fold_slots(torch.from_numpy(vals.astype(np.int64)),
                           torch.from_numpy(lens), 32)
    assert np.array_equal(_u32(jw), tw.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("k_overlap,max_words", [(8, 600), (4, 600), (16, 40)])
def test_assemble_matches_jax(k_overlap, max_words):
    rng = np.random.default_rng(k_overlap + max_words)
    P, W = 300, 3
    words = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    lens = rng.integers(0, 3 * 32 + 1, P).astype(np.int32)
    lens[rng.random(P) < 0.4] = 0                 # empty pieces are dropped
    lens[rng.random(P) < 0.2] = 1                 # many pieces per word
    jo, jt, jf = CJ.assemble(jnp.asarray(words), jnp.asarray(lens),
                             max_words, k_overlap=k_overlap)
    to, tt, tf = CV.assemble(torch.from_numpy(words.astype(np.int64)),
                             torch.from_numpy(lens), max_words,
                             k_overlap=k_overlap)
    assert np.array_equal(_u32(jo), to.numpy())
    assert int(jt) == int(tt)
    assert bool(jf) == bool(tf)


def test_searchsorted_sides_match_jax():
    ce = np.array([3, 3, 7, 7, 7, 12, 2 ** 30, 2 ** 30], np.int32)
    q = np.array([0, 3, 4, 7, 12, 13, 2 ** 30], np.int32)
    for side, right in (("left", False), ("right", True)):
        ref = np.asarray(jnp.searchsorted(jnp.asarray(ce), jnp.asarray(q),
                                          side=side))
        got = torch.searchsorted(torch.from_numpy(ce).long(),
                                 torch.from_numpy(q).long(), right=right)
        assert np.array_equal(ref, got.numpy())


def _pack_both(pic, mb_w, mb_h, max_words):
    f = _fields(pic)
    ref = CJ.pack_p_slice_full(*(jnp.asarray(a) for a in f), mb_w=mb_w,
                               mb_h=mb_h, max_words=max_words)
    got = CV.pack_p_slice_full(*(torch.from_numpy(a) for a in f), mb_w=mb_w,
                               mb_h=mb_h, max_words=max_words)
    return ref, got


def _sps_pps(mb_w, mb_h):
    sps = SPS(pic_width_in_mbs_minus1=mb_w - 1,
              pic_height_in_map_units_minus1=mb_h - 1,
              log2_max_frame_num_minus4=0,
              log2_max_pic_order_cnt_lsb_minus4=4)
    return sps, PPS()


# one frame size for the content variants (one JAX compile) plus a
# single-column picture
@pytest.mark.parametrize("mb_w,mb_h,seed,kw", [
    (6, 4, 0, {}),
    (6, 4, 1, {"skip_frac": 0.0, "dense": True}),
    (6, 4, 2, {"skip_frac": 0.8}),
    (6, 4, 3, {"max_lvl": 30, "dense": True}),
    (1, 3, 4, {}),
])
def test_pack_p_slice_full_matches_jax_and_host(mb_w, mb_h, seed, kw):
    rng = np.random.default_rng(seed)
    pic = random_fast_pic(rng, mb_w, mb_h, **kw)
    n = mb_w * mb_h
    ref, got = _pack_both(pic, mb_w, mb_h, n * 220 + 64)
    for k in ("words", "nbits", "ovf", "skip", "bits_per_mb"):
        assert np.array_equal(_u32(ref[k]) if k == "words"
                              else np.asarray(ref[k]), got[k].numpy()), k
    assert not bool(got["ovf"])
    # the packed words + header equal the host serializer's slice
    host_pic = PictureData(mb_w, mb_h)
    for k in ("inter_mode", "mv", "cbp", "luma_coef", "luma_nnz",
              "chroma_dc", "chroma_coef", "chroma_nnz"):
        getattr(host_pic, k)[:] = getattr(pic, k)
    host_pic.mb_class[:] = MB_INTER
    host_pic.ref_idx[:] = 0
    host_pic.slice_id[:] = 0
    host_pic.qp[:] = 28
    host_pic.skip[:] = got["skip"].numpy()
    sps, pps = _sps_pps(mb_w, mb_h)
    host = serialize_slice(host_pic, sps, pps, slice_type=SliceType.P,
                           frame_num=1, idr=False, qp=28, poc_lsb=2)
    nbits = int(got["nbits"])
    bw = BitWriter()
    write_slice_header(bw, sps, pps, slice_type=SliceType.P, frame_num=1,
                       idr=False, qp=28, poc_lsb=2)
    bw.append_bitstream(got["words"][:(nbits + 31) // 32].numpy()
                        .astype(">u4").tobytes(), nbits)
    bw.rbsp_trailing_bits()
    assert bw.get_bytes() == host


def test_pack_overflow_small_budget():
    """A word budget below the slice size raises ovf in both packers."""
    rng = np.random.default_rng(11)
    pic = random_fast_pic(rng, 6, 4, skip_frac=0.0, dense=True)
    ref, got = _pack_both(pic, 6, 4, 16)
    assert bool(ref["ovf"]) and bool(got["ovf"])
    assert int(ref["nbits"]) == int(got["nbits"]) > 16 * 32
    assert np.array_equal(_u32(ref["words"]), got["words"].numpy())


def test_pack_overflow_giant_level():
    rng = np.random.default_rng(9)
    pic = random_fast_pic(rng, 6, 4, skip_frac=0.0)
    pic.luma_coef[0, 0, :4] = [9000, 5, 4, 3]
    pic.luma_nnz[0, 0] = 4
    pic.cbp[0] |= 1
    ref, got = _pack_both(pic, 6, 4, 24 * 220 + 64)
    assert bool(ref["ovf"]) and bool(got["ovf"])
