"""The port's wavefront I-frame encode (jm_tpu_torch/ops/intra.py)
against jm_tpu's intra_jax.i_frame_step at 64x48, every output exactly,
on smooth content (I16 wins often) and noise (I4 wins), at two QPs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jm_tpu.ops.intra_jax import i_frame_step as i_frame_step_jax
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.encoder.encoder import lambda_me, lambda_mode4
from jm_tpu_torch.ops.intra import i_frame_step

from test_pipe_stream import make_frames

W, H = 64, 48
KEYS = ("cls", "i4m", "i16m", "cmode", "cbp", "lcoef", "ldc", "lnnz", "cdc",
        "cac", "cnnz", "recY", "recU", "recV")


def _content(kind):
    if kind == "smooth":
        return make_frames(W, H, 1, seed=3)[0]
    rng = np.random.default_rng(8)
    Y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    Y[:, : W // 2] = Y[:, : W // 2] // 8 + 90        # mixed flat / busy
    return Y, Y[::2, ::2].copy(), Y[1::2, ::2].copy()


@pytest.mark.parametrize("kind,qp", [("smooth", 28), ("noise", 28),
                                     ("smooth", 40), ("noise", 18)])
def test_i_frame_step_matches_jax(kind, qp):
    Y, U, V = _content(kind)
    args = (qp, chroma_qp(qp, 0), lambda_me(qp), lambda_mode4(qp))
    ref = i_frame_step_jax(jnp.asarray(Y), jnp.asarray(U), jnp.asarray(V),
                           *args, mb_w=W // 16, mb_h=H // 16)
    got = i_frame_step(torch.from_numpy(Y), torch.from_numpy(U),
                       torch.from_numpy(V), *args, mb_w=W // 16,
                       mb_h=H // 16)
    for k in KEYS:
        want = np.asarray(ref[k])
        assert got[k].dtype == (torch.uint8 if k.startswith("rec")
                                else torch.int32), k
        assert np.array_equal(want, got[k].numpy()), k
    classes = set(got["cls"].tolist())
    assert classes <= {1, 2}


def test_predict_i4_all_is_predict_i4():
    """decoder/intra_pred.predict_i4_all, the host Intra4x4 coder's nine
    predictions at once, equals predict_i4 mode by mode on seeded edges
    (saturated ones among them) under every neighbour availability."""
    from jm_tpu_torch.decoder import intra_pred as IP
    rng = np.random.default_rng(4)
    for k in range(300):
        top = rng.integers(0, 256, 8).astype(np.int32)
        left = rng.integers(0, 256, 4).astype(np.int32)
        if k % 5 == 0:
            top[:], left[:] = 255, 255
        corner = int(rng.integers(0, 256))
        for avail_t in (False, True):
            for avail_l in (False, True):
                got = IP.predict_i4_all(top, left, corner, avail_t, avail_l)
                for m in range(9):
                    assert np.array_equal(got[m], IP.predict_i4(
                        m, top, left, corner, avail_t, avail_l)), m
