"""The port's BD-rate harness (jm_tpu_torch/tools/bdrate.py) against
jm_tpu's on the CPU:
- bd_rate / bd_psnr on the JM anchors recorded in tests/test_bdrate.py
  (best against fast, and fast against a copy shifted in rate and
  PSNR), equal to 1e-9;
- psnr_y and read_yuv on seeded planes and a seeded YUV file;
- run_ours (the port's Encoder, device="cpu") for the device presets
  fast (md_low) and fast_rd at 32x32, 3 seeded frames, QP 28: the same
  bits and PSNR as jm_tpu's.
run_jm needs a JM lencod binary, which the repository does not hold, so
no test runs it."""

import numpy as np
import pytest

from jm_tpu.tools import bdrate as jbd
from jm_tpu_torch.tools import bdrate

from test_bdrate import JM_ANCHOR_BEST, JM_ANCHOR_FAST
from test_pipe_stream import make_frames


def _split(points):
    return [b for b, _ in points], [p for _, p in points]


SHIFTED = [(int(b * 0.93), p + 0.21) for b, p in JM_ANCHOR_FAST]


@pytest.mark.parametrize("anchor,test", [
    (JM_ANCHOR_BEST, JM_ANCHOR_FAST), (JM_ANCHOR_FAST, SHIFTED)],
    ids=["best_vs_fast", "fast_vs_shifted"])
@pytest.mark.parametrize("fn", ["bd_rate", "bd_psnr"])
def test_bd_measures_match_jm(fn, anchor, test):
    args = (*_split(anchor), *_split(test))
    got, want = getattr(bdrate, fn)(*args), getattr(jbd, fn)(*args)
    assert isinstance(got, float)
    assert abs(got - want) <= 1e-9
    assert got != 0.0


def test_psnr_and_read_yuv_match_jm(tmp_path):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (48, 64), np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-3, 4, a.shape), 0, 255)
    assert bdrate.psnr_y(a, b) == jbd.psnr_y(a, b)
    assert bdrate.psnr_y(a, a) == jbd.psnr_y(a, a) == 99.0
    raw = rng.integers(0, 256, 64 * 48 * 3 // 2 * 3 + 100, np.uint8)
    f = tmp_path / "clip.yuv"
    raw.tofile(f)
    got, want = bdrate.read_yuv(str(f), 64, 48, 5), \
        jbd.read_yuv(str(f), 64, 48, 5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for gp, wp in zip(g, w):
            assert np.array_equal(gp, wp)


def test_presets_are_jm_tpus_on_the_port():
    assert set(bdrate.PRESETS) == set(jbd.PRESETS)
    for name, kw in jbd.PRESETS.items():
        # jm_tpu's device route defaults to device_rd=False
        want = dict(kw)
        if want.get("pipeline") == "device":
            want.setdefault("device_rd", False)
        assert bdrate.PRESETS[name] == want


@pytest.mark.parametrize("preset", ["fast", "fast_rd"])
def test_run_ours_matches_jm(preset):
    frames = make_frames(32, 32, 3)
    got = bdrate.run_ours(frames, 32, 32, 28, preset, device="cpu")
    want = jbd.run_ours(frames, 32, 32, 28, preset)
    assert got == want
    assert got[0] > 0 and 30.0 < got[1] < 99.0
