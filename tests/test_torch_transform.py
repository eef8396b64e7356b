"""The port's integer transforms and quantizers
(jm_tpu_torch/ops/transform.py, quant.py) against jm_tpu's, exactly,
on random int32 blocks with per-block QPs; outputs stay int32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jm_tpu.ops import quant as JQ
from jm_tpu.ops import transform as JT
from jm_tpu_torch.ops import quant as Q
from jm_tpu_torch.ops import transform as T

RNG_SEED = 3


def _blocks(shape, lo, hi, seed=RNG_SEED):
    return np.random.default_rng(seed).integers(lo, hi, shape) \
        .astype(np.int32)


def _same(ref, got):
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("name,lo,hi,shape", [
    ("forward4x4", -255, 256, (200, 4, 4)),
    ("inverse4x4", -3000, 3000, (200, 4, 4)),
    ("inverse4x4_round", -3000, 3000, (7, 30, 4, 4)),
    ("hadamard4x4", -4000, 4000, (200, 4, 4)),
    ("hadamard2x2", -4000, 4000, (3, 50, 2, 2)),
])
def test_transform_matches_jax(name, lo, hi, shape):
    x = _blocks(shape, lo, hi)
    _same(getattr(JT, name)(jnp.asarray(x)),
          getattr(T, name)(torch.from_numpy(x)))


@pytest.mark.parametrize("intra", [True, False])
def test_quant_dequant_4x4_match_jax(intra):
    w = _blocks((300, 4, 4), -9000, 9000)
    qp = _blocks((300,), 0, 52, seed=4)
    lev_ref = JQ.quant_4x4(jnp.asarray(w), jnp.asarray(qp), intra)
    lev = Q.quant_4x4(torch.from_numpy(w), torch.from_numpy(qp), intra)
    _same(lev_ref, lev)
    _same(JQ.dequant_4x4(lev_ref, jnp.asarray(qp)),
          Q.dequant_4x4(lev, torch.from_numpy(qp)))


def test_quant_luma_dc_matches_jax():
    dc = _blocks((120, 4, 4), -20000, 20000)
    qp = _blocks((120,), 0, 52, seed=5)
    _same(JQ.quant_luma_dc(jnp.asarray(dc), jnp.asarray(qp)),
          Q.quant_luma_dc(torch.from_numpy(dc), torch.from_numpy(qp)))


@pytest.mark.parametrize("intra", [True, False])
def test_quant_chroma_dc_matches_jax(intra):
    dc = _blocks((40, 2, 2, 2), -8000, 8000)
    qp = _blocks((40, 2), 0, 52, seed=6)
    _same(JQ.quant_chroma_dc(jnp.asarray(dc), jnp.asarray(qp)[..., None, None],
                             intra),
          Q.quant_chroma_dc(torch.from_numpy(dc),
                            torch.from_numpy(qp)[..., None, None], intra))


def test_dc_scale_and_rshift_match_jax():
    qp = np.arange(52, dtype=np.int32)
    ref = np.asarray(JQ.FLAT_INV_SCALE_4x4)[qp, 0, 0]
    got = Q.dc_scale(torch.from_numpy(qp))
    assert np.array_equal(ref, got.numpy())
    x = _blocks((500,), -100000, 100000)
    for a in (1, 4, 6):
        assert np.array_equal(np.asarray(JQ.rshift_rnd_sf(jnp.asarray(x), a)),
                              Q.rshift_rnd_sf(torch.from_numpy(x), a).numpy())
