"""The RD tiers in the port's Encoder (pipeline="host") against jm_tpu's
Encoder, on the CPU, exactly (the codec is integer-exact: the tolerance
is zero): rdo 1-4 (tier 3 with the simulated lossy decoders,
num_decoders / loss_rate_a), I_PCM (enable_ipcm 1 and 2, in CAVLC,
CABAC and CABAC with B pictures) and rd_picture_decision (with
wp_mcprec and with periodic I pictures), rdo with redundant pictures and
two references: the payloads byte for byte,
the recon, and the decodes of the port's and jm_tpu's decoders equal to
the recon; the options exercised (I_PCM, Intra4x4 in P pictures, the
trial QPs recorded, more intra MBs with lossy decoders); the refusals.
The configurations of jm_tpu's tests/test_rdo.py on its clips cut to
32x32 (its noise at QP 6 for I_PCM), 2-3 frames; the trellis's streams
are tests/test_torch_rdoq_streams.py, the device route's in
tests/test_torch_encoder.py."""

import numpy as np
import pytest

import torch_streams as S
from jm_tpu.encoder.encoder import Encoder as JaxEncoder
from jm_tpu.encoder.encoder import EncoderConfig as JaxConfig
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from test_pipe_stream import make_frames
from test_rdo import _seq
from test_torch_ipcm import noise_patch
from torch_streams import one_torch_thread  # noqa: F401


def _noise(n):
    """test_rdo.py's uniform noise at 32x32: I_PCM wins at QP 6."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, (32, 32), np.uint8),
             rng.integers(0, 256, (16, 16), np.uint8),
             rng.integers(0, 256, (16, 16), np.uint8)) for _ in range(n)]


def _smooth(n, w=32, h=32):
    """test_rdo.py's md-tier clip (smoothed noise, moving) at w x h."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (128 + 32, 160 + 32)).astype(np.float32)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.clip(base * 1.5, 0, 255).astype(np.uint8)
    return [(base[2 * i:2 * i + h, 3 * i:3 * i + w].copy(),
             base[2 * i:2 * i + h, 3 * i:3 * i + w][::2, ::2].copy(),
             base[2 * i:2 * i + h, 3 * i:3 * i + w][1::2, ::2].copy())
            for i in range(n)]


def clip(name):
    """The frames of a named clip, n of them for name + str(n): test_rdo.py's
    sequence (seq) and noise at 32x32, its md-tier clip at 32x32 (smooth)
    and 96x80 (mid), tests/torch_streams.py's motion clip at 32x32
    (motion), seq's fade, and a 32x32 clip with a new 16x16 noise patch
    in each frame (patch), where P pictures choose Intra4x4."""
    kind, n = name.rstrip("0123456789"), int(name[len(name.rstrip(
        "0123456789")):])
    if kind == "seq":
        return _seq(n, 32, 32)
    if kind == "noise":
        return _noise(n)
    if kind == "smooth":
        return _smooth(n)
    if kind == "mid":
        return _smooth(n, 96, 80)
    if kind == "motion":
        return S.motion_clip(n, 32, 32)
    if kind == "fade":
        return S.fade(_seq(n, 32, 32))
    if kind == "patch":
        return noise_patch(make_frames(32, 32, n, seed=1), at=16, size=16)
    raise KeyError(name)


# case -> (config, clip, QP)
CASES = {
    "rdo1_sub8x8": (dict(rdo=1, sub8x8=True), "seq3", 30),
    "rdo1_cabac": (dict(rdo=1, entropy="cabac"), "seq2", 30),
    "rdo1_cabac_adapt": (dict(rdo=1, entropy="cabac",
                              cabac_adapt_init=True), "seq2", 30),
    "rdo1_intra": (dict(rdo=1, intra_period=1), "seq2", 30),
    "rdo2": (dict(rdo=2), "smooth2", 30),
    "rdo3_errdo": (dict(rdo=3, num_decoders=6, loss_rate_a=12), "seq3", 30),
    "rdo4": (dict(rdo=4), "smooth2", 30),
    "rdo1_patch_cavlc": (dict(rdo=1), "patch2", 20),
    "rdo1_patch_cabac": (dict(rdo=1, entropy="cabac"), "patch2", 20),
    "ipcm2_cavlc": (dict(enable_ipcm=2), "noise2", 6),
    "ipcm2_cabac": (dict(enable_ipcm=2, entropy="cabac"), "noise2", 6),
    "ipcm2_cabac_b": (dict(enable_ipcm=2, entropy="cabac", num_b=1),
                      "noise3", 6),
    "ipcm1_rdo1_cavlc": (dict(enable_ipcm=1, rdo=1), "noise2", 6),
    "ipcm1_rdo1_cabac": (dict(enable_ipcm=1, rdo=1, entropy="cabac"),
                         "noise2", 6),
    # the RD redundant coding counts the primary's two references' bits
    "rdo1_redundant_num_ref2": (dict(rdo=1, redundant_period=1, num_ref=2),
                                "seq3", 30),
    "rdpd": (dict(rd_picture_decision=True), "seq2", 30),
    "rdpd_intra": (dict(rd_picture_decision=True, intra_period=2), "seq3",
                   30),
    "rdpd_wp_mcprec": (dict(rd_picture_decision=True, weighted_pred=1,
                            wp_mcprec=1), "fade2", 30),
}
_RUNS = {}


def host_run(cfg: dict, frames, qp: int):
    """frames through encode_frame + flush by jm_tpu's Encoder and the
    port's (pipeline="host") with the keywords cfg at qp: (frames,
    jm_tpu payloads, jm_tpu results, port encoder, port payloads)."""
    h, w = frames[0][0].shape
    jenc = JaxEncoder(JaxConfig(width=w, height=h, qp=qp, **cfg))
    enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, pipeline="host",
                                **cfg), device="cpu")
    out = []
    for e in (jenc, enc):
        pay = [e.encode_frame(*f) for f in frames]
        pay[-1] += e.flush()
        out.append(pay)
    return frames, out[0], jenc.results, enc, out[1]


def _run(case):
    if case not in _RUNS:
        cfg, name, qp = CASES[case]
        _RUNS[case] = host_run(cfg, clip(name), qp)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_rd_payloads_match_jm(case):
    S.check_byte_identical(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_rd_decodes_to_recon(case):
    """Both decoders give the port's recon, picture by picture in decode
    order."""
    S.check_decodes(_run(case))


def host_mix(enc, key):
    """MBs of a decision over the host-coded P and B pictures."""
    return sum(r["mix"].get(key, 0) for r in enc.results if "mix" in r)


@pytest.mark.parametrize("case", list(CASES))
def test_rd_options_act(case):
    """Each option shows in what was coded: I_PCM MBs (all of them when
    forced), Intra4x4 MBs in P pictures under rdo, the three trial QPs
    of rd_picture_decision (the shipped one among them)."""
    cfg, _name, qp = CASES[case]
    enc = _run(case)[3]
    n_mbs = enc.mb_w * enc.mb_h
    if cfg.get("enable_ipcm") == 2:
        assert host_mix(enc, "ipcm") == n_mbs * (len(enc.results) - 1)
    if cfg.get("enable_ipcm") == 1:
        assert host_mix(enc, "ipcm") > 0
    if case.startswith("rdo1_patch"):
        # Intra4x4 in P slices: the MPM beside inter MBs, the native
        # CAVLC serializer's and the CABAC writer's P intra types
        assert host_mix(enc, "i4") > 0
    if cfg.get("rd_picture_decision"):
        for r in enc.results[1:]:
            qps = [t["qp"] for t in r["trials"]]
            assert qps[:3] == [qp, qp - 1, qp + 1]
            assert r["qp"] in qps
        assert "trials" not in enc.results[0]


def test_errdo_buys_intra():
    """With six lossy decoders (loss 12 %) the RD decision codes more
    intra MBs than the clean rdo=1 run on the same clip (jm_tpu's
    test_errdo_loss_aware_rdo)."""
    lossy = _run("rdo3_errdo")[3]
    clean = Encoder(EncoderConfig(width=32, height=32, qp=30, rdo=1,
                                  pipeline="host"), device="cpu")
    for f in clip("seq3"):
        clean.encode_frame(*f)
    intra = [sum(host_mix(e, k) for k in ("i16", "i4", "ipcm"))
             for e in (lossy, clean)]
    assert intra[0] > intra[1]


@pytest.mark.parametrize("field,value", [
    ("rdo", 5), ("rdo", -1), ("rdoq", 2), ("rdoq_dc", 2), ("rdoq_cr", -1),
    ("rdoq_dc_cr", 2), ("enable_ipcm", 3), ("num_decoders", -1),
    ("loss_rate_a", 101), ("rd_picture_decision", 1), ("rdo", 1.0)])
def test_rd_refusals(field, value):
    with pytest.raises(ValueError, match=field):
        Encoder(EncoderConfig(**{field: value}), device="cpu")
