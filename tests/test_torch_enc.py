"""The port's P-frame pipeline (jm_tpu_torch/ops/enc.py, enc_rd.py)
against jm_tpu's enc_jax / enc_rd at 96x80, exactly: the whole
p_frame_rd_pipe (packed words, every decision and coefficient field, the
skip mask and the next reference state), fed jm_tpu's prep_ref output
through convert.ref_state_from_numpy; and the stages whose arithmetic
changed form (float32 SAD sums instead of a matmul, an index gather
instead of the one-hot column matmul, first-index argmin ties)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jm_tpu.ops import enc_jax as EJ
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.convert import qpc_tables, ref_state_from_numpy
from jm_tpu_torch.common.types import PPS
from jm_tpu_torch.encoder.encoder import lambda_me, lambda_mode4
from jm_tpu_torch.ops import enc as E

from test_pipe_stream import make_frames

W, H, QP, SR = 96, 80, 30, 16
MB_W, MB_H = W // 16, H // 16


def _packed(frame):
    Y, U, V = frame
    buf = np.empty((H + H // 2, W), np.uint8)
    buf[:H] = Y
    buf[H:, : W // 2] = U
    buf[H:, W // 2:] = V
    return buf


@pytest.fixture(scope="module")
def clip():
    frames = make_frames(W, H, 3, seed=2)
    # frame 1 gets motion boundaries inside MBs (rows from y=40 and
    # columns from x=40 follow frame 2's motion), so partitions split
    Y = frames[1][0].copy()
    Y[40:] = frames[2][0][40:]
    Y[:, 40:] = frames[2][0][:, 40:]
    frames[1] = (Y, Y[::2, ::2].copy(), Y[1::2, ::2].copy())
    ref = tuple(np.asarray(a) for a in EJ.prep_ref(*(jnp.asarray(p)
                                                     for p in frames[0])))
    return frames, ref


@pytest.fixture(scope="module")
def pipes(clip):
    frames, ref = clip
    n = MB_W * MB_H
    max_words = max(4096, n * 2) + 64
    cb, cr = qpc_tables(PPS())
    scal = (QP, chroma_qp(QP, 0), lambda_me(QP), lambda_mode4(QP))
    jout, jstate = EJ.p_frame_rd_pipe(
        jnp.asarray(_packed(frames[1])), *(jnp.asarray(a) for a in ref),
        *scal, jnp.asarray(cb.numpy()), jnp.asarray(cr.numpy()),
        mb_w=MB_W, mb_h=MB_H, sr=SR, max_words=max_words)
    tout, tstate = E.p_frame_rd_pipe(
        torch.from_numpy(_packed(frames[1])),
        *ref_state_from_numpy(*ref), *scal, cb, cr,
        mb_w=MB_W, mb_h=MB_H, sr=SR, max_words=max_words)
    return jax.device_get((jout, jstate)), (tout, tstate)


def test_words_ext_and_flags_match(pipes):
    (jout, _), (tout, _) = pipes
    want = np.asarray(jout["words_ext"]).astype(np.int64)
    got = tout["words_ext"]
    assert got.dtype == torch.int64
    assert np.array_equal(want, got.numpy())
    assert want[0] > 0 and want[1] == 0          # a real, packed slice


@pytest.mark.parametrize("key", ["inter_mode", "mv4", "luma_scan",
                                 "luma_nnz", "cbp", "chroma_dc",
                                 "chroma_scan", "chroma_nnz", "intra_mask",
                                 "recY", "recU", "recV"])
def test_core_fields_match(pipes, key):
    (jout, _), (tout, _) = pipes
    want = np.asarray(jout["core"][key])
    got = tout["core"][key].numpy()
    assert want.shape == got.shape
    assert np.array_equal(want, got)


def test_skip_and_next_reference_state_match(pipes):
    (jout, jstate), (tout, tstate) = pipes
    assert np.array_equal(np.asarray(jout["skip"]), tout["skip"].numpy())
    assert bool(tout["skip"].any())
    for j, t in zip(jstate, tstate):
        assert t.dtype == torch.uint8
        assert np.array_equal(np.asarray(j), t.numpy())


def test_mode_mix_is_exercised(pipes):
    (_, _), (tout, _) = pipes
    modes = set(tout["core"]["inter_mode"].tolist())
    assert len(modes) >= 2


def test_luma_planes_match():
    frames = make_frames(W, H, 1, seed=5)
    Y = frames[0][0]
    want = np.asarray(EJ.make_luma_planes_dev(jnp.asarray(Y)))
    assert np.array_equal(want, E.make_luma_planes(torch.from_numpy(Y))
                          .numpy())


def test_me_int_sweep_matches_jax(clip):
    frames, ref = clip
    Y = frames[1][0]
    lam = lambda_me(QP)
    sweep = jax.jit(functools.partial(EJ.me_int_sweep, mb_w=MB_W, mb_h=MB_H,
                                      sr=SR, lam=lam))
    jmv, jcost = sweep(jnp.asarray(Y), jnp.asarray(ref[0][0]))
    tmv, tcost = E.me_int_sweep(torch.from_numpy(Y),
                                torch.from_numpy(np.array(ref[0][0])), MB_W,
                                MB_H, SR,
                                lam)
    assert tmv.dtype == torch.int32
    assert np.array_equal(np.asarray(jmv), tmv.numpy())
    assert np.array_equal(np.asarray(jcost), tcost.numpy())


def test_band_windows_match_one_hot_extraction(clip):
    """The index gather equals the band row gather + one-hot column
    matmul, including columns outside the band (zero) and clamped rows."""
    _, ref = clip
    planes = ref[0]
    off, width = EJ.band_geometry(SR)
    band = EJ.build_band(jnp.asarray(planes), MB_W, SR)
    rng = np.random.default_rng(4)
    q = 200
    m = rng.integers(0, MB_W, q).astype(np.int32)
    r0 = rng.integers(-3, planes.shape[1] - 5, q).astype(np.int32)
    c0 = rng.integers(-4, width - 4, q).astype(np.int32)
    rows = EJ._band_rows(band, jnp.asarray(m), jnp.asarray(r0), 10)
    want = np.asarray(EJ._col_extract(rows, jnp.asarray(c0), 10))
    got = E.band_windows(torch.from_numpy(np.array(planes)),
                         torch.from_numpy(m),
                         torch.from_numpy(r0), torch.from_numpy(c0), 10, 10,
                         16, off, width)
    assert np.array_equal(want.astype(np.int32), got.numpy())


def test_argmin_ties_keep_first_index():
    """Mode decisions rely on first-index ties, as jnp.argmin gives."""
    f = np.array([[3.0, 1.0, 1.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                  [np.inf, 2.0, np.inf, 2.0]], np.float32)
    i = np.array([[4, 2, 2, 2], [0, 1, 0, 0], [7, 7, 7, 7]], np.int32)
    for a in (f, i):
        want = np.asarray(jnp.argmin(jnp.asarray(a), axis=1))
        assert np.array_equal(want, torch.argmin(torch.from_numpy(a),
                                                 dim=1).numpy())
        assert np.array_equal(want, torch.from_numpy(a).min(dim=1)
                              .indices.numpy())
