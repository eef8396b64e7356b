"""The port's decoder device stages (jm_tpu_torch/ops/dec.py) against
jm_tpu/ops/dec_jax.py, bit for bit, on inputs made from a seed with
numpy: the residual decode over levels up to +-2^15, every QP and
non-zero chroma QP offsets; the inter reconstruction with 1 and 3
references, MVs far past the padding in all four directions and a mixed
inter mask. The reference states come from jm_tpu's prep_ref through
convert.ref_state_from_numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jm_tpu.common.types import PPS as JPPS
from jm_tpu.decoder.recon import build_inv_scale as jm_build_inv_scale
from jm_tpu.ops import dec_jax as DX
from jm_tpu.ops import enc_jax as EJ
from jm_tpu.ops.interp import PAD as JM_PAD
from jm_tpu.ops.interp import QPEL_TAB as JM_QPEL_TAB
from jm_tpu_torch.common.types import PPS
from jm_tpu_torch.convert import qpc_tables, ref_state_from_numpy
from jm_tpu_torch.decoder.recon import build_inv_scale
from jm_tpu_torch.ops import dec
from jm_tpu_torch.ops.consts import PAD, QPEL_TAB

MB_W, MB_H = 4, 3
N = MB_W * MB_H


def test_layout_constants_match():
    """The planes prep_ref builds are indexed with jm_tpu's padding and
    quarter-pel plane table (0 INT, 1 B, 2 H, 3 J)."""
    assert PAD == JM_PAD == 32
    assert QPEL_TAB == JM_QPEL_TAB


def _pps(cb, cr):
    flat = [[16] * 16 for _ in range(6)]
    return (PPS(chroma_qp_index_offset=cb, second_chroma_qp_index_offset=cr,
                scaling_list_4x4=flat),
            JPPS(chroma_qp_index_offset=cb, second_chroma_qp_index_offset=cr,
                 scaling_list_4x4=flat, scaling_list_8x8=[[16] * 64] * 6))


@pytest.mark.parametrize("seed,lev_max,qp_lo,qp_hi,cb,cr", [
    (0, 8, 0, 51, 0, 0),
    (1, 2 ** 15, 0, 17, -4, 6),
    (2, 2 ** 15, 18, 51, 12, -12),
    (3, 300, 0, 51, 3, 3),
])
def test_p_dec_residuals_matches_jax(seed, lev_max, qp_lo, qp_hi, cb, cr):
    rng = np.random.default_rng(seed)
    luma = rng.integers(-lev_max, lev_max + 1, (N, 16, 16)).astype(np.int32)
    luma *= rng.random((N, 16, 16)) < 0.4
    cdc = rng.integers(-lev_max, lev_max + 1, (N, 2, 4)).astype(np.int32)
    cac = rng.integers(-lev_max, lev_max + 1, (N, 2, 4, 16)).astype(np.int32)
    cac[..., 0] = 0
    qp = rng.integers(qp_lo, qp_hi + 1, N).astype(np.int32)
    qp[:2] = (qp_lo, qp_hi)
    pps, jpps = _pps(cb, cr)
    tab4 = build_inv_scale(pps)
    jtab4 = jm_build_inv_scale(jpps)[0]
    np.testing.assert_array_equal(tab4, jtab4)
    qcb, qcr = qpc_tables(pps)
    want = DX.p_dec_residuals(
        jnp.asarray(luma), jnp.asarray(cdc), jnp.asarray(cac),
        jnp.asarray(qp), *(jnp.asarray(tab4[i]) for i in (3, 4, 5)),
        jnp.asarray(qcb.numpy()), jnp.asarray(qcr.numpy()),
        mb_w=MB_W, mb_h=MB_H)
    got = dec.p_dec_residuals(
        torch.as_tensor(luma), torch.as_tensor(cdc), torch.as_tensor(cac),
        torch.as_tensor(qp), *(torch.as_tensor(tab4[i]) for i in (3, 4, 5)),
        qcb, qcr, mb_w=MB_W, mb_h=MB_H)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ref_states(rng, R):
    """R random reference pictures, prepared by jm_tpu's prep_ref."""
    H, W = 16 * MB_H, 16 * MB_W
    states = []
    for _ in range(R):
        Y = rng.integers(0, 256, (H, W), np.uint8)
        U = rng.integers(0, 256, (H // 2, W // 2), np.uint8)
        V = rng.integers(0, 256, (H // 2, W // 2), np.uint8)
        states.append(tuple(np.asarray(a) for a in EJ.prep_ref(
            jnp.asarray(Y), jnp.asarray(U), jnp.asarray(V))))
    return [np.stack([s[k] for s in states]) for k in range(3)]


@pytest.mark.parametrize("seed,R,inter_frac", [
    (0, 1, 1.0),
    (1, 3, 1.0),
    (2, 3, 0.6),
    (3, 1, 0.5),
])
def test_inter_recon_p_matches_jax(seed, R, inter_frac):
    rng = np.random.default_rng(seed)
    H, W = 16 * MB_H, 16 * MB_W
    planes, padU, padV = _ref_states(rng, R)
    mv = rng.integers(-40, 41, (N, 16, 2)).astype(np.int32)
    # MVs reaching past the padding in every direction (quarter-pel)
    far = 4 * (PAD + 20)
    mv[0, :, 0] = -far - 4 * W
    mv[1, :, 0] = far + 4 * W
    mv[2, :, 1] = -far - 4 * H
    mv[3, :, 1] = far + 4 * H
    mv[4, ::2] = rng.integers(-far - 4 * W, far + 4 * W, (8, 2))
    mv[5] = rng.integers(-4 * PAD, 4 * PAD, (16, 2)) * 3 + 1
    inter = rng.random(N) < inter_frac
    inter[:6] = True
    ref_idx = rng.integers(0, R, (N, 4)).astype(np.int8)
    ref_idx[~inter] = -1
    res_l = rng.integers(-300, 301, (N, 16, 4, 4)).astype(np.int32)
    res_c = rng.integers(-300, 301, (N, 2, 4, 4, 4)).astype(np.int32)
    want = DX.inter_recon_p(
        jnp.asarray(mv), jnp.asarray(ref_idx), jnp.asarray(res_l),
        jnp.asarray(res_c), jnp.asarray(planes), jnp.asarray(padU),
        jnp.asarray(padV), jnp.asarray(inter), mb_w=MB_W, mb_h=MB_H)
    st = ref_state_from_numpy(planes, padU, padV)
    got = dec.inter_recon_p(
        torch.as_tensor(mv), torch.as_tensor(ref_idx), torch.as_tensor(res_l),
        torch.as_tensor(res_c), *st, torch.as_tensor(inter),
        mb_w=MB_W, mb_h=MB_H)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
