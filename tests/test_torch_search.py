"""The host coders' fast searchers in the port's Encoder against
jm_tpu's, on the CPU, exactly: EPZS (search_mode 3) with and without the
HME pyramid's predictors (hme), UMHex (1) and UMHex simple (2), in P
pictures with one to four references and sub-8x8 partitions, in B
pictures, with long-term references and after a picture of the device
route (whose stored motion gives EPZS its temporal predictors); the
payloads byte for byte, the recon, the decodes of both decoders, on
tests/torch_streams.motion_clip at 96x80, QP 30. jm_tpu's quirk, kept:
search_mode and hme do not change the coding of a P picture on the
device route. And encoder/me_epzs.py, me_umhex.py against jm_tpu's
numpy searchers on seeded pictures: hme_sweep, and each searcher's MVs,
stop criterion state and SAD evaluations."""

import numpy as np
import pytest
import torch

from jm_tpu.encoder import me_epzs as JEP
from jm_tpu.encoder import me_umhex as JUM
from jm_tpu.ops import interp as JI
from jm_tpu_torch.encoder import me_epzs as EP
from jm_tpu_torch.encoder import me_umhex as UM
from jm_tpu_torch.ops import enc as E

import torch_streams as S
from torch_streams import one_torch_thread  # noqa: F401

CASES = {
    "epzs": (dict(search_mode=3), 3, "host"),
    "epzs_hme_num_ref4": (dict(search_mode=3, hme=True, num_ref=4), 5, "host"),
    "epzs_b_hme": (dict(search_mode=3, hme=True, num_b=1), 5, "host"),
    "epzs_sub8x8": (dict(search_mode=3, sub8x8=True, num_ref=2), 3, "host"),
    "epzs_after_device": (dict(search_mode=3, num_ref=2, device_rd=True), 4,
                          "device"),
    "umhex_b_cabac": (dict(search_mode=1, num_ref=2, subpel_satd=False,
                           entropy="cabac", num_b=1), 5, "host"),
    "umhex_sub8x8_hme": (dict(search_mode=1, sub8x8=True, hme=True), 3,
                         "host"),
    "umhexs_long_term": (dict(search_mode=2, long_term_period=3, num_ref=2),
                         4, "host"),
}
_RUNS = {}


def _run(case):
    if case not in _RUNS:
        cfg, n, pipeline = CASES[case]
        _RUNS[case] = S.option_run(cfg, S.motion_clip(n), pipeline)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_search_payloads_match_jm(case):
    S.check_byte_identical(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_search_decodes_to_recon(case):
    S.check_decodes(_run(case))


@pytest.mark.parametrize("case", list(CASES))
def test_searcher_ran(case):
    """Every host-coded P picture searched with the searcher: its SAD
    evaluations counted."""
    enc = _run(case)[3]
    ps = [r for r in enc.results if r["type"] == "P" and "mix" in r]
    assert ps and all(r["evals"] > 0 for r in ps)


def test_search_mode_ignored_on_the_device_route():
    """jm_tpu's quirk, kept: with pipeline="device" and one reference, a
    P picture's coding does not depend on search_mode and hme (neither
    is a term of _device_path_ok or _pipe_ok); the stream equals the
    full search's, through encode_frame (the pipe's case is
    search_mode_hme of tests/torch_resilience.py)."""
    frames = S.motion_clip(3)
    runs = [S.option_run(dict(search_mode=m, hme=m == 3, device_rd=True),
                         frames, "device") for m in (3, 0)]
    S.check_byte_identical(runs[0])
    assert runs[0][4] == runs[1][4]
    assert not any("mix" in r for r in runs[0][3].results)


class _Ref:
    """A reference as the searchers read it."""

    def __init__(self, luma_planes, motion, Y):
        self.luma_planes, self.motion, self.Y = luma_planes, motion, Y


def _refs(seed, n_refs, port: bool):
    frames = S.motion_clip(n_refs + 1, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for f in frames[:n_refs]:
        planes = (E.prep_ref(*(torch.from_numpy(p) for p in f))[0].numpy()
                  if port else JI.make_luma_planes(f[0]))
        mv = rng.integers(-24, 25, (30, 16, 2)).astype(np.int32)
        out.append(_Ref(planes, (mv,), f[0]))
    return frames[n_refs][0], out


def test_hme_sweep_matches_jm():
    cur, refs = _refs(5, 1, True)
    for sr in (4, 16):
        assert np.array_equal(EP.hme_sweep(cur, refs[0].Y, 6, 5, sr),
                              JEP.hme_sweep(cur, refs[0].Y, 6, 5, sr))


@pytest.mark.parametrize("name", ["EPZSearcher", "UMHexSearcher",
                                  "UMHexSmpSearcher"])
@pytest.mark.parametrize("hme", [False, True])
def test_searcher_matches_jm(name, hme):
    """Every partition of every MB of a seeded picture against two
    references, in raster order with its result committed to the motion
    field as an encoder does: the port's searcher and jm_tpu's give the
    same MVs, stop-criterion costs and evaluation counts."""
    cur, prefs = _refs(7, 2, True)
    _, jrefs = _refs(7, 2, False)
    cls = getattr(EP if name == "EPZSearcher" else UM, name)
    jcls = getattr(JEP if name == "EPZSearcher" else JUM, name)
    mv_p = np.zeros((30, 16, 2), np.int32)
    mv_j = np.zeros((30, 16, 2), np.int32)
    a = cls(cur, prefs, 6, 5, 16, 6, mv_p, use_hme=hme)
    b = jcls(cur, jrefs, 6, 5, 16, 6, mv_j, use_hme=hme)
    rng = np.random.default_rng(3)
    for addr in range(30):
        for quads in ((0, 1, 2, 3), (0, 1), (2, 3), (0, 2), (1, 3), (0,),
                      (3,)):
            pred = rng.integers(-40, 41, 2).astype(np.int32)
            seed = None
            for r in range(2):
                got = a.search(addr, r, quads, pred, seed=seed)
                want = b.search(addr, r, quads, pred, seed=seed)
                assert np.array_equal(got, want)
                seed = got if r == 0 else seed
        mv_p[addr] = mv_j[addr] = 4 * got
    assert a.n_evals == b.n_evals
    for bt in a.prev_sad:
        assert np.array_equal(a.prev_sad[bt], b.prev_sad[bt])
