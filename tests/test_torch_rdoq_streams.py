"""The trellis (rdoq, with rdoq_dc, rdoq_cr, rdoq_dc_cr) in the port's
Encoder (pipeline="host") against jm_tpu's Encoder, on the CPU, exactly:
the configurations of jm_tpu's tests/test_rdoq.py (CAVLC and CABAC, with
rdo, sub8x8, num_ref=2, transform8x8, num_b=1), with basic-unit rate
control in CABAC, whose MB bits the slice's running CABAC engine counts,
and the trellis's copied limits (none under custom quant, none in a
CABAC B picture); on its md-tier clip at 96x80 (2 frames, QP 28;
jm_tpu's clip is QCIF foreman, cut to hold the tests' time) and the
motion and sequence clips at 32x32 (3-4 frames): payloads, recon, both
decoders' decodes, where the trellis acts; and the CABAC device route,
where it does nothing."""

import pytest

import torch_streams as S
from jm_tpu_torch.common.types import SliceType
from jm_tpu_torch.encoder.encoder import Encoder, EncoderConfig
from jm_tpu_torch.encoder.p_intra import IntraMBCoder
from test_torch_rdo import clip, host_run
from torch_streams import one_torch_thread  # noqa: F401

_ALL = dict(rdoq=1, rdoq_dc=1, rdoq_cr=1, rdoq_dc_cr=1)
# case -> (config, clip, QP)
CASES = {
    "rdoq_cavlc": (dict(rdoq=1), "mid2", 28),
    "rdoq_cabac": (dict(rdoq=1, entropy="cabac"), "mid2", 28),
    "rdoq_all_cavlc": (dict(_ALL, rdo=1, sub8x8=True, num_ref=2),
                       "motion3", 28),
    "rdoq_all_cabac": (dict(_ALL, rdo=1, transform8x8=True, num_b=1,
                            entropy="cabac"), "motion3", 28),
    "rdoq_burc_cabac": (dict(rdoq=1, entropy="cabac", rc_enable=True,
                             rc_bitrate=10000.0, rc_basic_unit=1), "seq4",
                        30),
    "rdoq_adaptive_rounding": (dict(rdoq=1, adaptive_rounding=True),
                               "seq3", 30),
    "rdoq_cabac_b": (dict(rdoq=1, entropy="cabac", num_b=1), "seq3", 30),
}
_RUNS = {}
_TRELLIS = {}


def _run(case):
    """The case's run; the port's trellis calls by slice type counted in
    _TRELLIS[case]."""
    if case not in _RUNS:
        cfg, name, qp = CASES[case]
        calls = _TRELLIS[case] = {}
        mp = pytest.MonkeyPatch()
        orig = IntraMBCoder._trellis_luma4

        def spy(self, *a, **kw):
            calls[self.stype] = calls.get(self.stype, 0) + 1
            return orig(self, *a, **kw)

        mp.setattr(IntraMBCoder, "_trellis_luma4", spy)
        try:
            _RUNS[case] = host_run(cfg, clip(name), qp)
        finally:
            mp.undo()
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_rdoq_payloads_match_jm(case):
    S.check_byte_identical(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_rdoq_decodes_to_recon(case):
    S.check_decodes(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_rdoq_acts(case):
    """Where the trellis acts, as in jm_tpu: it changes the first
    (host-coded) I picture; with basic units the MB QPs move within a P
    picture; under custom quant (adaptive rounding) it does nothing; in
    a CABAC stream with B pictures it codes the I and P pictures (the
    slice's running engine) but not the B pictures (none)."""
    cfg, name, qp = CASES[case]
    frames, _want, _res, enc, got = _run(case)
    calls = _TRELLIS[case]
    if cfg.get("rc_enable"):
        assert any(len(r.get("mb_qps", ())) > 1 for r in enc.results)
        return
    h, w = frames[0][0].shape
    kw = {k: v for k, v in cfg.items() if not k.startswith("rdoq")}
    plain = Encoder(EncoderConfig(width=w, height=h, qp=qp,
                                  pipeline="host", **kw), device="cpu")
    if case == "rdoq_adaptive_rounding":
        assert calls == {}
        assert [plain.encode_frame(*f) for f in frames] == got
        return
    if case == "rdoq_cabac_b":
        assert SliceType.I in calls and SliceType.P in calls
        assert SliceType.B not in calls
    assert plain.encode_frame(*frames[0]) != got[0]


def test_cabac_device_route_has_no_trellis():
    """CABAC on the device route: rdoq leaves the pipe but codes nothing
    otherwise (no running engine prices the levels; the device I picture
    ignores it), so the stream equals the same configuration without it
    (jm_tpu's device CABAC stream without rdoq is held by
    tests/test_torch_cabac.py)."""
    frames = clip("seq3")
    kw = dict(width=32, height=32, qp=30, device_rd=True, entropy="cabac",
              intra_mb_refresh=2)
    got = [Encoder(EncoderConfig(**kw, **extra), device="cpu")
           .encode_stream(frames) for extra in (_ALL, {})]
    assert got[0] == got[1]
