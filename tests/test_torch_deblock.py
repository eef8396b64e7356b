"""The port's deblock (jm_tpu_torch/ops/deblock.py) against jm_tpu's:
compute_bs against compute_bs_jax, and the plain wavefront against both
deblock_jax and the Pallas kernels in interpret mode, bit for bit, on
the cases of tests/test_deblock_pallas.py. The CUDA kernels themselves
run only on the card (chip_smoke.py holds them against deblock_plain);
here their constant tables are held against the numpy ones."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jm_tpu.common.tables import chroma_qp
from jm_tpu.ops.deblock_jax import compute_bs_jax, deblock_jax
from jm_tpu.ops.deblock_pallas import deblock_pallas
from jm_tpu_torch import kernels
from jm_tpu_torch.common.tables import ALPHA_TABLE, BETA_TABLE, TC0_TABLE
from jm_tpu_torch.ops.deblock import compute_bs, deblock, deblock_plain

from test_deblock_jax import random_pic, slice_params

# one frame size for the parameter variants (one JAX compile), plus the
# single-row and single-column edge shapes
CASES = [
    (6, 4, 0, {}, {}),
    (6, 4, 1, {"multi_ref": True}, {}),
    (6, 4, 2, {"intra_frac": 1.0}, {}),
    (6, 4, 3, {"intra_frac": 0.0}, {}),
    (6, 4, 4, {"t8_frac": 0.5}, {}),
    (6, 4, 7, {}, {"disable": 2, "a_off": 2, "b_off": -2}),
    (6, 4, 8, {"t8_frac": 0.4}, {"disable": 1}),
    (6, 4, 9, {"multi_ref": True}, {"a_off": -3, "b_off": 4}),
    (1, 4, 5, {}, {}),
    (6, 1, 6, {}, {}),
]


def _bs_inputs(pic):
    return (pic.mb_class, pic.luma_nnz, pic.transform8x8.astype(np.int32),
            pic.mv, pic.mv_l1, pic.ref_pic_id, pic.ref_pic_id_l1)


def _case(mb_w, mb_h, seed, kw, skw):
    rng = np.random.default_rng(seed)
    pic = random_pic(rng, mb_w, mb_h, **kw)
    if skw.get("disable") == 2:
        half = pic.n_mbs // 2
        pic.slice_id[:half] = 0
        pic.slice_id[half:] = 1
    sp = slice_params(pic, **skw)
    rng = np.random.default_rng(seed + 100)
    H, W = 16 * mb_h, 16 * mb_w
    planes = (rng.integers(0, 256, (H, W), np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), np.uint8))
    qpc_cb = np.array([chroma_qp(q, 0) for q in range(52)], np.int32)
    qpc_cr = np.array([chroma_qp(q, 2) for q in range(52)], np.int32)
    per_mb = (pic.qp.astype(np.int32), sp["disable_idc"], sp["alpha_off"],
              sp["beta_off"], sp["slice_id"],
              pic.transform8x8.astype(np.int32))
    return pic, planes, per_mb, qpc_cb, qpc_cr


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", CASES)
def test_compute_bs_matches_jax(mb_w, mb_h, seed, kw, skw):
    pic = _case(mb_w, mb_h, seed, kw, skw)[0]
    ref = compute_bs_jax(*(jnp.asarray(a) for a in _bs_inputs(pic)),
                         mb_w, mb_h)
    got = compute_bs(*(torch.from_numpy(np.asarray(a))
                       for a in _bs_inputs(pic)), mb_w, mb_h)
    for r, g in zip(ref, got):
        assert g.dtype == torch.int8
        assert np.array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", CASES)
def test_deblock_plain_matches_jax_and_pallas(mb_w, mb_h, seed, kw, skw):
    pic, planes, per_mb, qpc_cb, qpc_cr = _case(mb_w, mb_h, seed, kw, skw)
    bs = compute_bs_jax(*(jnp.asarray(a) for a in _bs_inputs(pic)),
                        mb_w, mb_h)
    jargs = (*(jnp.asarray(p) for p in planes), *bs,
             *(jnp.asarray(a) for a in per_mb),
             jnp.asarray(qpc_cb), jnp.asarray(qpc_cr))
    ref = deblock_jax(*jargs, mb_w=mb_w, mb_h=mb_h)
    # the Pallas interpreter compiles per frame size: hold it at 6x4 only
    pal = deblock_pallas(*jargs, mb_w=mb_w, mb_h=mb_h, interpret=True) \
        if (mb_w, mb_h) == (6, 4) else ref
    targs = (*(torch.from_numpy(p) for p in planes),
             *(torch.from_numpy(np.array(b)) for b in bs),
             *(torch.from_numpy(a) for a in per_mb),
             torch.from_numpy(qpc_cb), torch.from_numpy(qpc_cr))
    got = deblock_plain(*targs, mb_w=mb_w, mb_h=mb_h)
    via_entry = deblock(*targs, mb_w=mb_w, mb_h=mb_h)
    for r, p, g, e, name in zip(ref, pal, got, via_entry, "YUV"):
        assert g.dtype == torch.uint8
        assert np.array_equal(np.asarray(r), g.numpy()), name
        assert np.array_equal(np.asarray(p), g.numpy()), name
        assert torch.equal(g, e), name


def test_kernel_constant_tables_match_numpy():
    src = (Path(kernels.__file__).parent / "deblock.cu").read_text()

    def table(name):
        m = re.search(r"__constant__ int " + name + r"[^=]*=\s*\{(.*?)\};",
                      src, re.S)
        return np.array([int(v) for v in re.findall(r"-?\d+", m.group(1))])

    assert np.array_equal(table("kAlpha"), np.asarray(ALPHA_TABLE))
    assert np.array_equal(table("kBeta"), np.asarray(BETA_TABLE))
    assert np.array_equal(table("kTc0").reshape(3, 52),
                          np.asarray(TC0_TABLE))


def test_kernel_wrappers_refuse_cpu_tensors():
    mb_w, mb_h = 2, 2
    n = mb_w * mb_h
    Y = torch.zeros((32, 32), dtype=torch.uint8)
    U = torch.zeros((16, 16), dtype=torch.uint8)
    bs = torch.zeros((8, 8), dtype=torch.int8)
    per_mb = [torch.zeros(n, dtype=torch.int32) for _ in range(6)]
    tab = torch.zeros(52, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.deblock_luma(Y, bs, bs, *per_mb, mb_w=mb_w, mb_h=mb_h)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.deblock_chroma(U, U, bs, bs, *per_mb, tab, tab,
                               mb_w=mb_w, mb_h=mb_h)
    # a non-CPU request goes to the kernels, never to the plain version
    meta = [t.to("meta") for t in (Y, U, U, bs, bs, *per_mb, tab, tab)]
    with pytest.raises(ValueError, match="CUDA"):
        deblock(*meta, mb_w=mb_w, mb_h=mb_h)
