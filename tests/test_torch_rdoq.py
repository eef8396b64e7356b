"""The port's trellis quantization (jm_tpu_torch/encoder/rdoq.py) and the
running CABAC engine of the RD bit counts (encoder/rdo.CabacRate) against
jm_tpu's, on the CPU, exactly (the tolerance is zero): the derived
tables; trellis_4x4 on seeded blocks for every block type (luma DC,
Intra16x16 AC, luma 4x4, chroma DC, chroma AC) with CAVLC at each nC
class and with CABAC from seeded context states, and trellis_8x8, at
three QPs, intra and inter; CabacRate's per-MB bits and committed bytes
on the PictureData of a jm_tpu CABAC RD encode; the CAVLC bit count of
the trellis (cavlc_write.residual_block_bits) against the block writer's
length."""

import numpy as np
import pytest

from jm_tpu.decoder.cabac import CabacContexts as JaxContexts
from jm_tpu.encoder import rdo as jm_rdo
from jm_tpu.encoder import rdoq as jm_rdoq
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.bitstream.bitwriter import BitWriter
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.convert import picture_from_numpy
from jm_tpu_torch.decoder.cabac import CabacContexts
from jm_tpu_torch.encoder import rdoq as RQ
from jm_tpu_torch.encoder.cavlc_write import (residual_block_bits,
                                              write_residual_block)
from jm_tpu_torch.encoder.rdo import CabacRate, RDOptions, lambda_mode

_TABLES = ("ENTROPY_BITS", "ESTERR_4x4", "ESTERR_8x8", "_ESTERR4_SCAN",
           "_MF4_SCAN", "_ESTERR8_SCAN", "_MF8_SCAN")


@pytest.mark.parametrize("name", _TABLES)
def test_tables_match_jm(name):
    a, b = getattr(RQ, name), getattr(jm_rdoq, name)
    assert a.dtype == b.dtype and np.array_equal(a, b)


# block kind -> (block_type, coefficients, max_coeff, start, dc)
_KINDS = {"luma_dc": (0, 16, 16, 0, True), "i16_ac": (1, 15, 15, 1, False),
          "luma4x4": (5, 16, 16, 0, False),
          "chroma_dc": (6, 4, 4, 0, True), "chroma_ac": (7, 15, 15, 1, False)}
_CASES = [(kind, "cavlc", nc) for kind in _KINDS
          for nc in ((-1,) if kind == "chroma_dc" else (0, 2, 4, 8))]
_CASES += [(kind, "cabac", seed) for kind in _KINDS for seed in (0, 1)]
_CASES += [("luma8x8", "cabac", seed) for seed in (0, 1)]


def _contexts(seed: int):
    """The port's and jm_tpu's context sets with the same seeded (state,
    MPS) in every context (a P model at QP 28 overwritten)."""
    rng = np.random.default_rng(100 + seed)
    port, jm = CabacContexts(False, 0, 28), JaxContexts(False, 0, 28)
    for name, arr in vars(port).items():
        if not isinstance(arr, np.ndarray):
            continue
        arr[..., 0] = rng.integers(0, 63, arr.shape[:-1])
        arr[..., 1] = rng.integers(0, 2, arr.shape[:-1])
        getattr(jm, name)[...] = arr
    return port, jm


@pytest.mark.parametrize("kind,entropy,arg", _CASES)
def test_trellis_matches_jm(kind, entropy, arg):
    """Seeded Laplacian coefficients scaled to each QP (levels 0..~6): the
    port's levels are jm_tpu's for 8 blocks at each QP and intra flag,
    with lambda_mode of the QP (the 0.57 one for intra)."""
    rng = np.random.default_rng(_CASES.index((kind, entropy, arg)))
    ctxs = _contexts(arg) if entropy == "cabac" else (None, None)
    for qp in (12, 28, 40):
        for intra in (True, False):
            lam = lambda_mode(qp, intra_rdoq=intra)
            for _ in range(8):
                scale = 2 ** (qp // 6) * 24.0
                if kind == "luma8x8":
                    w = np.round(rng.laplace(0, scale / 4, 64)).astype(
                        np.int64)
                    cbf = int(rng.integers(4))
                    got = RQ.trellis_8x8(w, qp, intra, lam, ctxs=ctxs[0],
                                         cbf_ctx=cbf)
                    want = jm_rdoq.trellis_8x8(w, qp, intra, lam,
                                               ctxs=ctxs[1], cbf_ctx=cbf)
                    assert np.array_equal(got, want), (qp, intra, w)
                    continue
                bt, n, max_coeff, start, dc = _KINDS[kind]
                w = np.round(rng.laplace(0, scale, n)).astype(np.int64)
                w[rng.random(n) < 0.3] = 0
                kw = dict(entropy=entropy, block_type=bt, dc=dc,
                          start=start)
                if entropy == "cavlc":
                    kw.update(nc=arg, max_coeff=max_coeff)
                    got = RQ.trellis_4x4(w, qp, intra, lam, **kw)
                    want = jm_rdoq.trellis_4x4(w, qp, intra, lam, **kw)
                else:
                    cbf = int(rng.integers(4))
                    got = RQ.trellis_4x4(w, qp, intra, lam, ctxs=ctxs[0],
                                         cbf_ctx=cbf, **kw)
                    want = jm_rdoq.trellis_4x4(w, qp, intra, lam,
                                               ctxs=ctxs[1], cbf_ctx=cbf,
                                               **kw)
                assert got.dtype == want.dtype
                assert np.array_equal(got, want), (qp, intra, w)


class _Coder:
    """The state CabacRate reads from a host coder: pic, qp, rd (its PPS),
    num_ref."""

    def __init__(self, pic, qp, pps):
        self.pic, self.qp, self.num_ref = pic, qp, 1
        self.rd = RDOptions(cabac=True, pps=pps)


def test_cabac_rate_matches_jm():
    """jm_tpu's last P picture of a CABAC rdo=1 encode (64x48, 2 frames of
    tests/test_rdo.py's clip): the port's CabacRate over a copy of its
    PictureData gives jm_tpu's marginal bits for every MB, staged and
    then committed in slice order, and the same engine bytes."""
    from test_rdo import _seq
    jenc = JaxEncoder(JaxConfig(width=64, height=48, qp=30, rdo=1,
                                entropy="cabac"))
    for f in _seq(2, 64, 48):
        jenc.encode_frame(*f)
    fe = jenc._last_fe
    assert (fe.pic.mb_class != 0).any() or (fe.pic.skip).any()
    pic = picture_from_numpy(fe.pic)
    ours = CabacRate(_Coder(pic, fe.qp, jenc.pps), SliceType.P)
    theirs = jm_rdo.CabacRate(fe, fe.stype)
    for addr in range(pic.n_mbs):
        assert ours.mb_bits(addr) == theirs.mb_bits(addr), addr
        ours.commit(addr)
        theirs.commit(addr)
        assert ours.w.eng.bits_out == theirs.w.eng.bits_out
    assert bytes(ours.bw.buf) == bytes(theirs.bw.buf)


@pytest.mark.parametrize("max_coeff,nc", [(16, 0), (16, 2), (16, 4),
                                          (16, 9), (15, 1), (15, 5),
                                          (4, -1), (8, -2)])
def test_residual_block_bits_is_the_written_length(max_coeff, nc):
    """cavlc_write.residual_block_bits, the trellis's and the Intra4x4
    RD's rate, counts the bits write_residual_block writes (or raises as
    it does) on seeded blocks of every density and level range."""
    rng = np.random.default_rng(max_coeff * 31 + nc)
    for _ in range(400):
        c = np.zeros(max_coeff, np.int64)
        k = int(rng.integers(0, max_coeff + 1))
        scale = int(rng.choice([1, 2, 5, 40, 3000]))
        c[rng.choice(max_coeff, k, replace=False)] = rng.integers(
            -scale, scale + 1, k)
        bw = BitWriter()
        try:
            write_residual_block(bw, c, nc, max_coeff)
            want = bw.bitpos
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                residual_block_bits(c.tolist(), nc, max_coeff)
            continue
        assert residual_block_bits(c.tolist(), nc, max_coeff) == want, c
