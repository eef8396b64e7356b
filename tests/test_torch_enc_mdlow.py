"""The port's md_low P path and all-modes RD tier (jm_tpu_torch/ops/enc.py,
enc_rd.py) against jm_tpu's enc_jax / enc_rd on the CPU, exactly:
luma_residual_inter (with blocks on both sides of the quadrant and MB
coefficient-cost thresholds), the inter chroma residual, every field of
p_frame_step(rd=False) and p_frame_bs at 96x80 and 64x48, and every
field of p_mode_rd_device(top_modes=4), J included (the whole md_low P
pipe is held byte for byte in tests/test_torch_fallback.py's streams)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jm_tpu.ops import enc_jax as EJ
from jm_tpu.ops import enc_rd as RDJ
from jm_tpu_torch.common.tables import chroma_qp
from jm_tpu_torch.convert import ref_state_from_numpy
from jm_tpu_torch.encoder.encoder import lambda_me, lambda_mode4
from jm_tpu_torch.ops import enc as E
from jm_tpu_torch.ops import enc_rd as RD
from jm_tpu_torch.ops import quant as Q
from jm_tpu_torch.ops import transform as T

from test_pipe_stream import make_frames

QP, SR = 30, 16
SHAPES = [(96, 80), (64, 48)]
CORE_KEYS = ["inter_mode", "mv4", "luma_scan", "luma_nnz", "cbp",
             "chroma_dc", "chroma_scan", "chroma_nnz", "intra_mask",
             "recY", "recU", "recV"]
RD_KEYS = ["inter_mode", "mv_quad", "luma_scan", "luma_nnz", "cbp",
           "chroma_dc", "chroma_scan", "chroma_nnz", "recY_mbs", "recU_mbs",
           "recV_mbs", "j_win"]


def _clip(w, h):
    """Reference frame 0 and frame 1 with motion boundaries inside MBs
    (rows from h/2 and columns from w/2 follow frame 2's motion)."""
    frames = make_frames(w, h, 3, seed=2)
    Y = frames[1][0].copy()
    Y[h // 2:] = frames[2][0][h // 2:]
    Y[:, w // 2:] = frames[2][0][:, w // 2:]
    cur = (Y, Y[::2, ::2].copy(), Y[1::2, ::2].copy())
    ref = tuple(np.asarray(a) for a in EJ.prep_ref(*(jnp.asarray(p)
                                                     for p in frames[0])))
    return cur, ref


def _scalars():
    return QP, chroma_qp(QP, 0), lambda_me(QP), lambda_mode4(QP)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def steps(request):
    w, h = request.param
    mb_w, mb_h = w // 16, h // 16
    cur, ref = _clip(w, h)
    jout = jax.device_get(EJ.p_frame_step(
        *(jnp.asarray(p) for p in cur), *(jnp.asarray(a) for a in ref),
        *_scalars(), mb_w=mb_w, mb_h=mb_h, sr=SR, rd=False))
    tout = E.p_frame_step(*(torch.from_numpy(p) for p in cur),
                          *ref_state_from_numpy(*ref), *_scalars(),
                          mb_w=mb_w, mb_h=mb_h, sr=SR, rd=False)
    return (w, h), cur, ref, jout, tout


@pytest.mark.parametrize("key", CORE_KEYS)
def test_p_frame_step_md_low_fields_match(steps, key):
    _, _, _, jout, tout = steps
    want = np.asarray(jout[key])
    got = tout[key].numpy()
    assert want.shape == got.shape
    assert np.array_equal(want, got)


def test_md_low_decisions_are_mixed(steps):
    """The clip exercises skips, several partition modes and coded
    residuals."""
    tout = steps[4]
    assert len(set(tout["inter_mode"].tolist())) >= 2
    assert bool((tout["cbp"] == 0).any()) and bool((tout["cbp"] != 0).any())


def test_p_frame_bs_matches(steps):
    (w, h), _, _, jout, tout = steps
    kw = dict(mb_w=w // 16, mb_h=h // 16)
    jv, jh = EJ.p_frame_bs(jnp.asarray(jout["luma_nnz"]),
                           jnp.asarray(jout["mv4"]), **kw)
    tv, th = E.p_frame_bs(tout["luma_nnz"], tout["mv4"], **kw)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert int(tv.max()) >= 2


def _residual_inputs(seed, n, size):
    """Source blocks and predictions whose residual amplitude varies per
    MB (1..15), so the quantized levels sit on both sides of the JM
    coefficient-cost thresholds."""
    rng = np.random.default_rng(seed)
    orig = rng.integers(0, 256, (n, size, size)).astype(np.uint8)
    amp = rng.integers(1, 16, n)[:, None, None]
    noise = np.rint(rng.standard_normal((n, size, size)) * amp).astype(int)
    pred = np.clip(orig.astype(int) + noise, 0, 255).astype(np.int32)
    return orig, pred


@pytest.mark.parametrize("qp", [20, 28])
def test_luma_residual_inter_matches(qp):
    orig, pred = _residual_inputs(qp, 300, 16)
    want = jax.device_get(jax.jit(EJ.luma_residual_inter)(
        jnp.asarray(orig), jnp.asarray(pred), qp))
    got = E.luma_residual_inter(torch.from_numpy(orig),
                                torch.from_numpy(pred), qp)
    for w_, g in zip(want, got):
        assert np.array_equal(np.asarray(w_), g.numpy())
    # both sides of the thresholds: MBs with levels dropped whole, quads
    # dropped in a coded MB, MBs coded in full
    cbp = got[2].numpy()
    res = torch.from_numpy(orig.astype(np.int32) - pred) \
        .reshape(-1, 4, 4, 4, 4).permute(0, 1, 3, 2, 4).reshape(-1, 16, 4, 4)
    levels = Q.quant_4x4(T.forward4x4(res),
                         torch.full(res.shape[:2], qp, dtype=torch.int32),
                         False)
    assert ((levels != 0).flatten(1).any(1).numpy() & (cbp == 0)).any()
    assert (cbp == 15).any() and ((cbp > 0) & (cbp < 15)).any()


@pytest.mark.parametrize("qp", [18, 30])
def test_chroma_residual_inter_matches(qp):
    ou, pu = _residual_inputs(qp + 1, 200, 8)
    ov, pv = _residual_inputs(qp + 2, 200, 8)
    qpc = chroma_qp(qp, 0)
    want = jax.device_get(jax.jit(EJ.chroma_residual_inter)(
        *(jnp.asarray(a) for a in (ou, ov, pu, pv)), qpc))
    got = E.chroma_residual(*(torch.from_numpy(a) for a in (ou, ov, pu, pv)),
                            qpc, False)
    for w_, g in zip(want, got):
        assert np.array_equal(np.asarray(w_), g.numpy())
    cbp_c = got[3].numpy()
    assert set(cbp_c.tolist()) == {0, 1, 2}


@pytest.fixture(scope="module")
def rd_full():
    """p_mode_rd_device(top_modes=4) on both sides, each fed its own
    pipeline's stages (held equal elsewhere) at 96x80."""
    w, h = SHAPES[0]
    mb_w, mb_h = w // 16, h // 16
    n = mb_w * mb_h
    cur, ref = _clip(w, h)
    qp, qpc, lam, _ = _scalars()
    mb_xy = np.stack([(np.arange(n) % mb_w) * 16,
                      (np.arange(n) // mb_w) * 16], axis=1).astype(np.int32)
    orig_q = cur[0].reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3) \
        .reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4).reshape(n, 4, 8, 8)
    ou = cur[1].reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3) \
        .reshape(n, 8, 8)
    ov = cur[2].reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3) \
        .reshape(n, 8, 8)

    @jax.jit
    def jax_full(Y, planes, padU, padV, orig_q, ou, ov, mb_xy):
        band = EJ.build_band(planes, mb_w, SR)
        cband = EJ.build_cband(padU, padV, mb_w, SR)
        int_mv, _ = EJ.me_int_sweep(Y, planes[0], mb_w, mb_h, SR, lam)
        pred = EJ.approx_pred_field(int_mv[:, 0], mb_w, mb_h)
        mv_q, _c, win = EJ.qpel_refine_dense(band, orig_q, int_mv, pred,
                                             lam, mb_xy, SR)
        return RDJ.p_mode_rd_device(band, cband, win, mv_q, int_mv, pred,
                                    orig_q, ou, ov, mb_xy, qp, qpc,
                                    mb_w=mb_w, mb_h=mb_h, sr=SR,
                                    top_modes=4)

    want = jax.device_get(jax_full(
        jnp.asarray(cur[0]), *(jnp.asarray(a) for a in ref),
        jnp.asarray(orig_q.astype(np.int16)), jnp.asarray(ou),
        jnp.asarray(ov), jnp.asarray(mb_xy)))

    planes, padU, padV = ref_state_from_numpy(*ref)
    t_q = torch.from_numpy(orig_q.astype(np.int32))
    t_xy = torch.from_numpy(mb_xy)
    int_mv, _ = E.me_int_sweep(torch.from_numpy(cur[0]), planes[0], mb_w,
                               mb_h, SR, lam)
    pred = E.approx_pred_field(int_mv[:, 0], mb_w, mb_h)
    mv_q, _c, win = E.qpel_refine_dense(planes, t_q, int_mv, pred, lam, t_xy,
                                        SR)
    got = RD.p_mode_rd_device(planes, padU, padV, win, mv_q, int_mv, pred,
                              t_q, torch.from_numpy(ou), torch.from_numpy(ov),
                              t_xy, qp, qpc, mb_w=mb_w, mb_h=mb_h, sr=SR,
                              top_modes=4)
    return want, got


@pytest.mark.parametrize("key", RD_KEYS)
def test_p_mode_rd_full_fields_match(rd_full, key):
    want, got = rd_full
    w_ = np.asarray(want[key])
    g = got[key].numpy()
    assert w_.shape == g.shape
    assert np.array_equal(w_, g)


def test_p_mode_rd_full_decisions_are_mixed(rd_full):
    _, got = rd_full
    assert len(set(got["inter_mode"].tolist())) >= 2
    assert bool((got["cbp"] != 0).any())
