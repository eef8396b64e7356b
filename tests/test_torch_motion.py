"""The host coders' motion options in the port's Encoder against
jm_tpu's, on the CPU, exactly (the codec is integer-exact: the tolerance
is zero): several list-0 references (num_ref 2-4, with long-term
references, list reordering, weighted prediction, redundant pictures,
data partitioning, byte-limited slices and B pictures), the P8x8
sub-partitions (sub8x8, CAVLC and CABAC, with the 8x8 transform) and the
fractional search by SAD (subpel_satd=False); the payloads byte for
byte, the recon, and the decode of the port's and of jm_tpu's decoder.
The clip: tests/torch_streams.motion_clip at 96x80, QP 30 (blockwise
motion, frame 3 a repeat of frame 1, so that the older reference and
the sub-partitions are chosen), 4 frames (5 with B pictures). Also:
the first P picture of pipeline="device" with num_ref=2 takes the
device route with one active reference under a PPS default of two;
ops/enc.full_search_sad_blk4 against jm_tpu's 4x4 table; subpel_refine
with extra_bits, use_satd and qpel_start against jm_tpu's; the Python
MBWriter's sub-partitions and te(v) against the native serializer and
jm_tpu's."""

import numpy as np
import pytest
import torch

from jm_tpu.encoder import me as JME
from jm_tpu.encoder.syntax import serialize_slice as jax_serialize_slice
from jm_tpu.ops import interp as JI
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.encoder import me as ME
from jm_tpu_torch.encoder.encoder import lambda_me, lambda_mode4
from jm_tpu_torch.encoder.p_host import PPicture
from jm_tpu_torch.encoder.syntax import serialize_slice
from jm_tpu_torch.ops import enc as E

import torch_streams as S
from torch_streams import one_torch_thread  # noqa: F401

CASES = {
    "num_ref2": (dict(num_ref=2), 3),
    "num_ref3": (dict(num_ref=3), 3),
    "sub8x8_cavlc": (dict(sub8x8=True), 3),
    "sub8x8_cabac": (dict(sub8x8=True, entropy="cabac"), 3),
    "sub8x8_num_ref2": (dict(sub8x8=True, num_ref=2), 3),
    "sub8x8_t8_cabac": (dict(sub8x8=True, num_ref=2, transform8x8=True,
                             entropy="cabac"), 3),
    "subpel_sad": (dict(subpel_satd=False, num_ref=2), 3),
    "long_term_b_cabac": (dict(num_ref=2, long_term_period=2, num_b=1,
                               entropy="cabac"), 5),
    "reorder_redundant": (dict(num_ref=2, ref_reorder=1, redundant_period=2,
                               poc_mem_mgmt=1), 3),
    "dp_slices": (dict(num_ref=2, sub8x8=True, data_partition=1,
                       slice_mode=2, slice_argument=300), 3),
    "wp_num_ref2": (dict(num_ref=2, weighted_pred=1), 3),
}
_RUNS = {}


def _run(case):
    if case not in _RUNS:
        cfg, n = CASES[case]
        frames = S.motion_clip(n)
        if cfg.get("weighted_pred"):
            frames = S.fade(frames)
        _RUNS[case] = S.option_run(cfg, frames)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_motion_option_payloads_match_jm(case):
    S.check_byte_identical(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_motion_option_chooses_its_partitions(case):
    """The options are exercised: P pictures coded from the older
    reference with several references, P_8x8 MBs with sub8x8."""
    cfg, _ = CASES[case]
    enc = _run(case)[3]
    ps = [r for r in enc.results if r["type"] == "P" and "mix" in r]
    assert ps
    if cfg.get("num_ref", 1) > 1:
        assert sum(r["ref1"] for r in ps) > 0
    if cfg.get("sub8x8"):
        assert sum(r["mix"]["p8x8"] for r in ps) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_motion_option_decodes_to_recon(case):
    S.check_decodes(_run(case))


@pytest.mark.parametrize("stream", [False, True])
def test_first_p_on_the_device_route_with_one_active_reference(stream):
    """pipeline="device", num_ref=2: the first P picture (one reference
    in the DPB) is coded on the device with num_ref_idx overridden to 1
    under the PPS default of 2, the later ones by the host P coder;
    through encode_frame and encode_stream."""
    run = S.option_run(dict(num_ref=2, device_rd=True), S.motion_clip(4),
                       pipeline="device", stream=stream)
    S.check_byte_identical(run)
    S.check_decodes(run)
    enc = run[3]
    assert enc.pps.num_ref_idx_l0_default_active_minus1 == 1
    assert ["mix" in r for r in enc.results] == [False, False, True, True]


def test_blk4_table_matches_jm():
    """ops/enc.full_search_sad_blk4 against jm_tpu's numpy 4x4 table, and
    its quadrants' sums against full_search_sad_quad."""
    frames = S.motion_clip(2)
    cur, ref = frames[1][0], frames[0][0]
    planes = E.prep_ref(*(torch.from_numpy(p) for p in frames[0]))[0]
    for sr in (1, 5, 16):
        got = E.full_search_sad_blk4(torch.from_numpy(cur), planes[0], 6, 5,
                                     sr).numpy()
        want = JME.full_search_blk4_sads(cur, JI.make_luma_planes(ref)[0], 6,
                                         5, sr, JI.PAD)
        assert got.dtype == np.int16 and np.array_equal(got, want)
        quad = E.full_search_sad_quad(torch.from_numpy(cur), planes[0], 6, 5,
                                      sr).numpy()
        assert np.array_equal(got[:, :, ME.QUAD_BLKS].sum(axis=3), quad)


@pytest.mark.parametrize("extra_bits,use_satd,qpel_start", [
    (0, True, False), (1, True, False), (3, False, False), (0, False, True),
    (2, True, True)])
def test_subpel_refine_matches_jm(extra_bits, use_satd, qpel_start):
    frames = S.motion_clip(2)
    cur = frames[1][0]
    planes = E.prep_ref(*(torch.from_numpy(p) for p in frames[0]))[0] \
        .numpy()
    jplanes = JI.make_luma_planes(frames[0][0])
    rng = np.random.default_rng(extra_bits + 2 * use_satd + 4 * qpel_start)
    h, w = cur.shape
    for _ in range(12):
        bw, bh = (int(v) for v in rng.choice([4, 8, 16], 2))
        px = int(rng.integers(0, (w - bw) // 4 + 1)) * 4
        py = int(rng.integers(0, (h - bh) // 4 + 1)) * 4
        mv = rng.integers(-20 if qpel_start else -5, 21 if qpel_start
                          else 6, 2).astype(np.int32)
        pred = rng.integers(-30, 31, 2).astype(np.int32)
        lam = int(rng.integers(1, 20))
        blk = cur[py:py + bh, px:px + bw]
        kw = dict(extra_bits=extra_bits, use_satd=use_satd,
                  qpel_start=qpel_start)
        got = ME.subpel_refine(blk, planes, px, py, mv, w, h, pred, lam, **kw)
        want = JME.subpel_refine(blk, jplanes, px, py, mv, w, h, pred, lam,
                                 **kw)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_sub_partition_tables_match_jm():
    assert ME.SUB_PARTS == JME.SUB_PARTS
    assert ME.SUB_MODE_BITS == JME.SUB_MODE_BITS


@pytest.mark.parametrize("num_ref,sub8x8", [(2, True), (3, False),
                                            (1, True)])
def test_python_writer_matches_native_and_jm(num_ref, sub8x8):
    """A P picture of the host P coder with num_ref references (the
    DPB's after the sub8x8_num_ref2 / num_ref3 runs) serialized by the
    Python MBWriter (the writer of data partitions and of basic-unit bit
    counts) equals the native serializer's slice and jm_tpu's: te(v)
    ref_idx and P_8x8 sub-partitions."""
    enc = _run("num_ref3" if num_ref == 3 else "sub8x8_num_ref2")[3]
    refs = enc.refs[:num_ref]
    frame = S.motion_clip(5)[4]
    src = torch.from_numpy(frame[0])
    sads, blk4 = [], []
    for r in refs:
        b = E.full_search_sad_blk4(src, r.state[0][0], 6, 5, 16).numpy()
        blk4.append(b)
        sads.append(b[:, :, ME.QUAD_BLKS].sum(axis=3))
    c = PPicture(frame, 30, 30, lambda_me(30), lambda_mode4(30),
                 [r.host_ref() for r in refs], sads, [list(range(30))], 16,
                 blk4=blk4, sub8x8=sub8x8)
    assert (c.pic.sub_mode.any() == sub8x8) and (c.ref1 > 0) == (num_ref > 1)
    kw = dict(slice_type=SliceType.P, frame_num=3, idr=False, qp=30,
              poc_lsb=8, num_ref_idx_l0=num_ref)
    py = serialize_slice(c.pic, enc.sps, enc.pps, native=False, **kw)
    assert py == serialize_slice(c.pic, enc.sps, enc.pps, **kw)
    assert py == jax_serialize_slice(c.pic, enc.sps, enc.pps, **kw)
