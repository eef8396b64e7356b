"""The port's deblock (jm_tpu_torch/ops/deblock.py) against jm_tpu's:
compute_bs against compute_bs_jax, and the plain wavefront against both
deblock_jax and the Pallas kernels in interpret mode, bit for bit, on
the cases of tests/test_deblock_pallas.py. The CUDA kernels themselves
run only on the card (chip_smoke.py holds them against deblock_plain);
here their constant tables are held against the numpy ones, and their
row-progress schedule is emulated MB by MB with the plain tile steps."""

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
from jm_tpu_torch.ops.deblock import (
    MbParams, chroma_horizontal, chroma_vertical, compute_bs, deblock,
    deblock_plain, luma_horizontal, luma_vertical)

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


def _case(mb_w, mb_h, seed, kw, skw, low_amplitude=False):
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
    if low_amplitude:       # steps below alpha / beta: the filters fire
        planes = tuple(p // 20 + 100 for p in planes)
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


@pytest.mark.parametrize("seed", [0, 1])
def test_deblock_plain_random_bs_matches_jax(seed):
    """bS drawn at random, 4 on inner edges too (as chip_smoke.py's kernel
    checks draw it), with every per-MB parameter random: deblock_plain,
    whose luma steps skip the strong filter where no line of an edge has
    bS 4, equals deblock_jax at 6x4."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h, n = 6, 4, 24
    planes = [(rng.integers(0, 256, (h, w)) // 20 + 100).astype(np.uint8)
              for h, w in ((64, 96), (32, 48), (32, 48))]
    bs = [rng.integers(0, 5, (16, 24)).astype(np.int8) for _ in range(2)]
    bs[0][:, 0] = 0
    bs[1][0] = 0
    per_mb = (rng.integers(0, 52, n), rng.integers(0, 3, n),
              rng.integers(-6, 7, n), rng.integers(-6, 7, n),
              np.arange(n) * 3 // n, rng.random(n) < 0.3)
    per_mb = tuple(np.asarray(a, np.int32) for a in per_mb)
    tabs = [np.array([chroma_qp(q, off) for q in range(52)], np.int32)
            for off in (-2, 3)]
    ref = deblock_jax(*(jnp.asarray(a) for a in (*planes, *bs, *per_mb,
                                                 *tabs)),
                      mb_w=mb_w, mb_h=mb_h)
    got = deblock_plain(*(torch.from_numpy(a) for a in (*planes, *bs,
                                                        *per_mb, *tabs)),
                        mb_w=mb_w, mb_h=mb_h)
    for r, g, p, name in zip(ref, got, planes, "YUV"):
        assert np.array_equal(np.asarray(r), g.numpy()), name
        assert not np.array_equal(g.numpy(), p), name


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


# ---------------------------------------------------------------------------
# the persistent kernels' schedule (deblock.cu), emulated MB by MB or phase
# by phase with the plain tile steps
# ---------------------------------------------------------------------------

SCHEDULE_CASES = CASES + [
    (2, 3, 10, {"t8_frac": 0.3}, {}),
    (7, 5, 11, {"multi_ref": True}, {"disable": 2, "a_off": 1, "b_off": 2}),
]
# the cases with two rows and two columns, where a rule one MB short of
# the dependency admits a wrong order
NEGATIVE_CASES = [c for c in SCHEDULE_CASES
                  if c[0] >= 2 and c[1] >= 2 and c[2] in (0, 10, 11)]
SENTINEL = -1


def _mb_order(mb_w, mb_h, lag, rng=None):
    """An order of whole MBs ("mb", b, c) that the rule progress[b-1] >=
    min(c + lag, mb_w) admits (progress: MBs of the row filtered): a
    random one, or (rng None) the one in which each lower row starts as
    soon as the rule lets it."""
    done = [0] * mb_h
    steps = []
    while len(steps) < mb_w * mb_h:
        ready = [b for b in range(mb_h) if done[b] < mb_w and (
            b == 0 or done[b - 1] >= min(done[b] + lag, mb_w))]
        b = int(rng.choice(ready)) if rng is not None else max(ready)
        steps.append(("mb", b, done[b]))
        done[b] += 1
    return steps


def _phase_order(mb_w, mb_h, rng=None, fringe=True):
    """An order of the kernels' phases: each row runs ("v", b, 0),
    ("h", b, 0), ("v", b, 1), ...; ("h", b, c) waits until c + 1 MBs of
    row b-1 are final. An MB is final once the next MB's vertical edges
    (which rewrite its right fringe), or for the last MB its own
    horizontal edges, are done: the kernels' rule. fringe=False forgets
    the next MB's left edge and counts an MB final once its own edges are
    done. Random, or (rng None) lower rows first."""
    ph = [0] * mb_h

    def final(b):
        if not fringe or ph[b] == 2 * mb_w:
            return ph[b] // 2
        return max(0, (ph[b] - 1) // 2)

    steps = []
    while len(steps) < 2 * mb_w * mb_h:
        ready = [b for b in range(mb_h) if ph[b] < 2 * mb_w and (
            ph[b] % 2 == 0 or b == 0 or final(b - 1) >= ph[b] // 2 + 1)]
        b = int(rng.choice(ready)) if rng is not None else max(ready)
        steps.append(("v" if ph[b] % 2 == 0 else "h", b, ph[b] // 2))
        ph[b] += 1
    return steps


def _emulate(planes, bs, per_mb, qpc_cb, qpc_cr, mb_w, mb_h, steps):
    """The kernels' data flow, one step at a time. A step filters one
    MB's vertical edges ("v"), horizontal edges ("h") or both ("mb") on a
    tile of the MB and the 4 samples left of and above it: the interior
    from the unfiltered input planes ("h": from the output, where "v" put
    it), the left fringe (for vertical edges) and the top fringe (for
    horizontal edges) from the output planes, which start as SENTINEL
    (zero padding above and left of the picture). What the step may change
    goes back to the output. Returns the output planes; asserts that no
    step read a SENTINEL."""
    src = [torch.from_numpy(p).to(torch.int32) for p in planes]
    out = [torch.zeros((n * mb_h + 4, n * mb_w + 4), dtype=torch.int32)
           for n in (16, 8, 8)]
    for o in out:
        o[4:, 4:] = SENTINEL
    mp = MbParams(*(torch.from_numpy(a) for a in per_mb), mb_w, mb_h)
    bs_v, bs_h = (torch.from_numpy(np.array(b)) for b in bs)
    tabs = (torch.from_numpy(qpc_cb), torch.from_numpy(qpc_cr))
    for kind, b, c in steps:
        ln, bv, bh = mp.lanes(torch.tensor([b]), torch.tensor([c]),
                              bs_v, bs_h)
        tiles = []
        for o, p, n in zip(out, src, (16, 8, 8)):
            y, x = n * b, n * c                   # the MB's padded corner
            tile = torch.zeros((n + 4, n + 4), dtype=torch.int32)
            if kind != "h":
                tile[4:, :4] = o[y + 4:y + n + 4, x:x + 4]
            if kind != "v":
                tile[:4, 4:] = o[y:y + 4, x + 4:x + n + 4]
            tile[4:, 4:] = o[y + 4:y + n + 4, x + 4:x + n + 4] \
                if kind == "h" else p[y:y + n, x:x + n]
            assert not (tile == SENTINEL).any(), f"{kind} ({b}, {c})"
            tiles.append(tile)
        ty, ct = tiles[0][None], torch.stack(tiles[1:])[None]
        if kind != "h":
            luma_vertical(ty, ln, bv)
            chroma_vertical(ct, ln, bv, *tabs)
        if kind != "v":
            luma_horizontal(ty, ln, bh)
            chroma_horizontal(ct, ln, bh, *tabs)
        for o, tile, n in zip(out, (ty[0], ct[0, 0], ct[0, 1]), (16, 8, 8)):
            y, x = n * b, n * c
            if kind != "h":
                o[y + 4:y + n + 4, x:x + 4] = tile[4:, :4]
            if kind != "v":
                o[y:y + 4, x + 4:x + n + 4] = tile[:4, 4:]
            o[y + 4:y + n + 4, x + 4:x + n + 4] = tile[4:, 4:]
    assert not any((o == SENTINEL).any() for o in out)
    return [o[4:, 4:].to(torch.uint8).numpy() for o in out]


def _schedule_refs(case, jax_ref=True):
    """(emulation args, deblock_plain's planes[, deblock_jax's]) of a
    low-amplitude case, so that the filters fire."""
    mb_w, mb_h = case[:2]
    pic, planes, per_mb, qpc_cb, qpc_cr = _case(*case, low_amplitude=True)
    bs = compute_bs_jax(*(jnp.asarray(a) for a in _bs_inputs(pic)),
                        mb_w, mb_h)
    targs = (*(torch.from_numpy(p) for p in planes),
             *(torch.from_numpy(np.array(b)) for b in bs),
             *(torch.from_numpy(a) for a in per_mb),
             torch.from_numpy(qpc_cb), torch.from_numpy(qpc_cr))
    plain = [g.numpy() for g in deblock_plain(*targs, mb_w=mb_w, mb_h=mb_h)]
    if case[4].get("disable") != 1:
        assert not np.array_equal(plain[0], planes[0])
    args = (planes, bs, per_mb, qpc_cb, qpc_cr, mb_w, mb_h)
    if not jax_ref:
        return args, plain
    ref = deblock_jax(*(jnp.asarray(p) for p in planes), *bs,
                      *(jnp.asarray(a) for a in per_mb),
                      jnp.asarray(qpc_cb), jnp.asarray(qpc_cr),
                      mb_w=mb_w, mb_h=mb_h)
    return args, plain, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", SCHEDULE_CASES)
def test_row_progress_schedule_matches_wavefront(mb_w, mb_h, seed, kw, skw):
    """Every order of whole MBs that progress[b-1] >= min(c + 2, mb_w)
    admits gives deblock_plain's and deblock_jax's planes, with the
    interior read from the input planes and no fringe read before it was
    written."""
    args, plain, ref = _schedule_refs((mb_w, mb_h, seed, kw, skw))
    rng = np.random.default_rng(seed)
    orders = [_mb_order(mb_w, mb_h, 2)] + [
        _mb_order(mb_w, mb_h, 2, rng) for _ in range(3)]
    for order in orders:
        for g, p, r, name in zip(_emulate(*args, order), plain, ref, "YUV"):
            assert np.array_equal(g, p), name
            assert np.array_equal(g, r), name


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", NEGATIVE_CASES)
def test_row_progress_lag_one_breaks_the_wavefront(mb_w, mb_h, seed, kw,
                                                   skw):
    """With min(c + 1, mb_w), MB (b, c) reads its top fringe before
    (b-1, c+1)'s left-edge filter has rewritten it: the order in which each
    lower row starts as soon as that rule lets it gives another luma plane
    (and the same order under c + 2 the right one)."""
    args, plain = _schedule_refs((mb_w, mb_h, seed, kw, skw), jax_ref=False)
    assert np.array_equal(_emulate(*args, _mb_order(mb_w, mb_h, 2))[0],
                          plain[0])
    assert not np.array_equal(_emulate(*args, _mb_order(mb_w, mb_h, 1))[0],
                              plain[0])


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", SCHEDULE_CASES)
def test_kernel_phase_schedule_matches_wavefront(mb_w, mb_h, seed, kw, skw):
    """The kernels' own, finer rule: vertical edges of (b, c) after (b,
    c-1) alone, horizontal edges once MB (b-1, c) is final. Every order it
    admits gives deblock_plain's and deblock_jax's planes."""
    args, plain, ref = _schedule_refs((mb_w, mb_h, seed, kw, skw))
    rng = np.random.default_rng(seed + 1)
    orders = [_phase_order(mb_w, mb_h)] + [
        _phase_order(mb_w, mb_h, rng) for _ in range(3)]
    for order in orders:
        for g, p, r, name in zip(_emulate(*args, order), plain, ref, "YUV"):
            assert np.array_equal(g, p), name
            assert np.array_equal(g, r), name


@pytest.mark.parametrize("mb_w,mb_h,seed,kw,skw", NEGATIVE_CASES)
def test_kernel_phase_schedule_needs_the_final_mb(mb_w, mb_h, seed, kw,
                                                  skw):
    """Counting an MB final once its own edges are done, before the next
    MB's left edge has rewritten its right fringe, admits an order that
    gives another luma plane."""
    args, plain = _schedule_refs((mb_w, mb_h, seed, kw, skw), jax_ref=False)
    assert np.array_equal(_emulate(*args, _phase_order(mb_w, mb_h))[0],
                          plain[0])
    assert not np.array_equal(
        _emulate(*args, _phase_order(mb_w, mb_h, fringe=False))[0],
        plain[0])
