"""Error concealment of lost and corrupt pictures, the port's copy of
jm_tpu/decoder/conceal.py (ldecod ConcealMode, configfile.h:44;
mbuffer.c conceal_lost_frames:1837; erc_do_i.c, erc_do_p.c):

- ``conceal_lost_frame``: a picture that never arrived (a frame_num gap,
  or a picture none of whose slices survived) becomes, with mode 1, a
  copy of the reference closest by POC (a device copy of its planes);
  with mode 2, that reference's list-0 motion replayed against its own
  references still in the DPB (``_motion_copy``: one batched call of
  ops/dec._mc_pred over every 4x4 block; blocks that are intra or whose
  reference left the DPB keep the copy). The frame stores a neutral
  motion field (no motion, no reference).
- ``conceal_mbs``: the MBs of lost or corrupt slices of a decoded picture
  (frame or field), in jm_tpu's onion order (the MB with most available
  4-neighbours first; a concealed MB becomes available), after the
  deblock, on the host copy of the deblocked planes. With a reference,
  each MB takes the candidate MV (zero, then the quadrant MVs of its
  available inter neighbours) whose 16x16 prediction best side-matches
  the available neighbours' border pixels (``_conceal_inter_mb``; the MV
  is written into the picture's motion); without one (the first IDR),
  the inverse-distance weighted average of the neighbours' borders
  (``_conceal_spatial_mb``).

Every format the decoder reads is covered (4:2:0 and 4:2:2, 8 to 14
bits; host planes uint8 or uint16, device states uint8 or int16), with
jm_tpu's behaviour copied where it departs from its own 8-bit 4:2:0
reading of the samples, for byte parity:
- the motion copy clips its predictions at 255 and casts the whole frame
  to uint8 (the copied samples wrap mod 256), and writes the chroma of a
  4:2:2 frame with 4:2:0 geometry (rows py / 2, the clamp at half the
  height; jm_tpu conceal.py:77-89);
- a concealed frame is a reference of 8 bits (its Frame's bit_depth
  stays 8): the integer plane of its reference state wraps mod 256 and
  its half samples clip at 255, while its output and a later frame copy
  keep its samples (``Frame.planes``);
- the spatial concealment clips at 255 and casts to uint8, and fills
  8 x 8 chroma blocks at 4:2:2 too (jm_tpu conceal.py:124-126, :162);
- the inter concealment casts its MC blocks to uint8 (:215, :228).
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoder.me import mc_chroma_block, mc_luma_block
from ..ops import dec as D
from ..ops.consts import PAD
from ..ops.enc import prep_ref
from .dpb import Frame


def closest_ref(frames: list[Frame], poc: int) -> Frame:
    """The reference frame of least |POC - poc|, the first in DPB order
    on a tie (jm_tpu conceal.py _closest_ref)."""
    refs = [f for f in frames if f.is_ref] or list(frames)
    return min(refs, key=lambda f: abs(f.poc - poc))


def frame_planes(f: Frame, h: int, w: int):
    """The (Y, U, V) device planes of reference frame f of an h x w
    picture: a concealed frame's own samples, else those of its state
    (ops/enc.prep_ref: the integer plane and the padded chroma, whose
    height gives the chroma format's)."""
    if f.planes is not None:
        return f.planes
    planes, pad_u, pad_v = f.state
    ch = pad_u.shape[0] - 2 * PAD
    return (planes[0, PAD:PAD + h, PAD:PAD + w],
            pad_u[PAD:PAD + ch, PAD:PAD + w // 2],
            pad_v[PAD:PAD + ch, PAD:PAD + w // 2])


def concealed_state(Y, U, V):
    """The reference state of a concealed frame, which jm_tpu keeps at 8
    bits whatever the stream's (its Frame's bit_depth is not set): the
    half samples clipped at 255 and, above 8 bits, the integer plane
    wrapped mod 256 (jm_tpu interp.make_luma_planes casts it to uint8);
    the chroma padded as it is."""
    state = prep_ref(Y, U, V)
    if Y.dtype != torch.uint8:
        state[0][0] &= 255
    return state


def conceal_lost_frame(dpb_frames: list[Frame], frame_num: int, poc: int,
                       mode: int, h: int, w: int):
    """The Frame standing for a picture that never arrived (jm_tpu
    conceal.py:33) and its (Y, U, V) device planes."""
    src = closest_ref(dpb_frames, poc)
    if mode >= 2 and src.motion is not None:
        Y, U, V = _motion_copy(dpb_frames, src, h, w)
    else:
        Y, U, V = (p.clone() for p in frame_planes(src, h, w))
    motion = None
    if src.motion is not None:
        mv, ref_idx, mv_l1, ref_idx_l1, rp0, rp1 = src.motion
        motion = (np.zeros_like(mv), np.full_like(ref_idx, -1),
                  np.zeros_like(mv_l1), np.full_like(ref_idx_l1, -1),
                  np.full_like(rp0, -1), np.full_like(rp1, -1))
    f = Frame(poc=poc, frame_num=frame_num, state=concealed_state(Y, U, V),
              is_ref=True, motion=motion, planes=(Y, U, V))
    return f, (Y, U, V)


def _motion_copy(dpb_frames: list[Frame], src: Frame, h: int, w: int):
    """jm_tpu conceal.py _motion_copy (:54): src's list-0 motion replayed
    against its references by uid, as one batched MC over every 4x4
    block; blocks that are intra or whose reference is not in the DPB
    keep src's pixels. As in jm_tpu, the predictions clip at 255 and the
    planes wrap mod 256 (uint8), and at 4:2:2 the chroma is predicted
    and written with 4:2:0 geometry, into the upper half of the planes
    (from the padded planes' first h / 2 + 2 PAD rows, where jm_tpu's
    clamp at h / 2 keeps its reads)."""
    mv, ref_idx, _mv1, _r1, ref_pic_id, _rp1 = src.motion
    dev = src.state[0].device
    mb_w, mb_h = w // 16, h // 16
    refs = list({f.uid: f for f in dpb_frames}.values())
    stack = np.full(ref_pic_id.shape, -1, np.int32)
    for k, f in enumerate(refs):
        stack[ref_pic_id == f.uid] = k
    stack[ref_idx < 0] = -1
    up = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    hc = h // 2 + 2 * PAD
    stacks = (torch.stack([f.state[0] for f in refs]),
              torch.stack([f.state[1][:hc] for f in refs]),
              torch.stack([f.state[2][:hc] for f in refs]))
    pred, cpred = D._mc_pred(up(mv), up(stack), *stacks, mb_w=mb_w,
                             mb_h=mb_h)
    n = mb_w * mb_h
    zl = torch.zeros((n, 16, 4, 4), dtype=torch.int32, device=dev)
    zc = torch.zeros((n, 2, 4, 4, 4), dtype=torch.int32, device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    # clipped at 255 (_recon at 8 bits)
    planes = D._recon(pred, cpred, zl, zc, every, mb_w=mb_w, mb_h=mb_h)
    # the 4x4 blocks predicted, as planes of 0 / 1
    blk = np.arange(16)
    valid = up((stack[:, (blk // 8) * 2 + (blk % 4) // 2] >= 0)
               .astype(np.int32))
    mask = D._recon(valid[..., None, None].expand(n, 16, 4, 4),
                    valid[..., None, None, None].expand(n, 16, 2, 2, 2),
                    zl, zc, every, mb_w=mb_w, mb_h=mb_h)
    out = []
    for m, p, s in zip(mask, planes, frame_planes(src, h, w)):
        top = torch.where(m.bool(), p.to(s.dtype), s[:p.shape[0]])
        o = torch.cat([top, s[p.shape[0]:]])
        out.append(o & 255 if o.dtype != torch.uint8 else o)
    return tuple(out)


# ---------------------------------------------------------------------------
# per-MB concealment (jm_tpu conceal.py:96-231) on host planes
# ---------------------------------------------------------------------------

class HostRef:
    """The host copy of a reference state, for the 16x16 / 8x8 MC of
    the per-MB inter concealment (encoder/me.py mc_luma_block /
    mc_chroma_block, the host coders' copies of jm_tpu's ops/interp.py
    ones)."""

    def __init__(self, state):
        self.luma_planes, pad_u, pad_v = (t.cpu().numpy() for t in state)
        self.chroma_pad = (pad_u, pad_v)


def conceal_mbs(Y, U, V, pic, lost, ref, mb_w: int, mb_h: int) -> int:
    """Conceal the MBs of ``lost`` ((N,) bool) in the host planes, in
    place, in onion order; ref: the HostRef of the reference to conceal
    from, or None (spatial concealment). Returns the number of MBs
    concealed (jm_tpu conceal.py conceal_mbs, :96)."""
    avail = ~lost.reshape(mb_h, mb_w).copy()
    todo = [tuple(p) for p in np.argwhere(~avail)]
    count = 0
    while todo:
        def n_avail(p):
            y, x = p
            return sum(1 for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))
                       if 0 <= y + dy < mb_h and 0 <= x + dx < mb_w
                       and avail[y + dy, x + dx])
        todo.sort(key=n_avail, reverse=True)
        y, x = todo.pop(0)
        if ref is not None:
            _conceal_inter_mb(Y, U, V, pic, ref, x, y, mb_w, mb_h, avail)
        else:
            _conceal_spatial_mb(Y, x, y, 16, avail, mb_w, mb_h)
            _conceal_spatial_mb(U, x, y, 8, avail, mb_w, mb_h)
            _conceal_spatial_mb(V, x, y, 8, avail, mb_w, mb_h)
        avail[y, x] = True
        count += 1
    return count


def _conceal_spatial_mb(plane, mbx, mby, bs, avail, mb_w, mb_h):
    """erc_do_i.c pixelConceal (jm_tpu conceal.py:132): each sample the
    inverse-distance weighted average, in float64, of the adjacent
    border samples of the available up / down / left / right MBs; 128
    without any."""
    px, py = mbx * bs, mby * bs
    ys, xs = np.mgrid[0:bs, 0:bs]
    num = np.zeros((bs, bs), np.float64)
    den = np.zeros((bs, bs), np.float64)
    sides = []
    if mby > 0 and avail[mby - 1, mbx]:
        sides.append((plane[py - 1, px:px + bs][None, :].astype(np.float64)
                      .repeat(bs, 0), ys + 1))
    if mby + 1 < mb_h and avail[mby + 1, mbx]:
        sides.append((plane[py + bs, px:px + bs][None, :].astype(np.float64)
                      .repeat(bs, 0), bs - ys))
    if mbx > 0 and avail[mby, mbx - 1]:
        sides.append((plane[py:py + bs, px - 1][:, None].astype(np.float64)
                      .repeat(bs, 1), xs + 1))
    if mbx + 1 < mb_w and avail[mby, mbx + 1]:
        sides.append((plane[py:py + bs, px + bs][:, None].astype(np.float64)
                      .repeat(bs, 1), bs - xs))
    if not sides:
        plane[py:py + bs, px:px + bs] = 128
        return
    for edge, dist in sides:
        wgt = 1.0 / dist
        num += wgt * edge
        den += wgt
    plane[py:py + bs, px:px + bs] = np.clip(
        num / den + 0.5, 0, 255).astype(np.uint8)


def _conceal_inter_mb(Y, U, V, pic, ref, mbx, mby, mb_w, mb_h, avail):
    """erc_do_p.c concealByTrial (jm_tpu conceal.py:165): the candidates
    zero and the quadrant MVs of the available inter neighbours facing
    the MB, in that order without repeats; each one's 16x16 prediction
    scored by the mean absolute difference of its border rows / columns
    against the available neighbours' adjacent pixels; the first of
    least score fills the MB (luma, and the 8 x 8 or, at 4:2:2, 8 x 16
    chroma) and its MV, reference 0 and the inter class go into pic."""
    h_img, w_img = Y.shape
    px, py = mbx * 16, mby * 16
    addr = mby * mb_w + mbx
    cands = [(0, 0)]
    for (dy, dx, quads) in ((-1, 0, (2, 3)), (1, 0, (0, 1)),
                            (0, -1, (1, 3)), (0, 1, (0, 2))):
        ny, nx = mby + dy, mbx + dx
        if 0 <= ny < mb_h and 0 <= nx < mb_w and avail[ny, nx]:
            naddr = ny * mb_w + nx
            if pic.ref_idx[naddr, 0] >= 0:
                for q in quads:
                    cands.append(tuple(int(v) for v in pic.mv[naddr, q]))
    uniq = list(dict.fromkeys(cands))

    def side_match(blk):
        e, n = 0.0, 0
        if mby > 0 and avail[mby - 1, mbx]:
            e += np.abs(blk[0].astype(np.int32)
                        - Y[py - 1, px:px + 16].astype(np.int32)).sum()
            n += 16
        if mby + 1 < mb_h and avail[mby + 1, mbx]:
            e += np.abs(blk[-1].astype(np.int32)
                        - Y[py + 16, px:px + 16].astype(np.int32)).sum()
            n += 16
        if mbx > 0 and avail[mby, mbx - 1]:
            e += np.abs(blk[:, 0].astype(np.int32)
                        - Y[py:py + 16, px - 1].astype(np.int32)).sum()
            n += 16
        if mbx + 1 < mb_w and avail[mby, mbx + 1]:
            e += np.abs(blk[:, -1].astype(np.int32)
                        - Y[py:py + 16, px + 16].astype(np.int32)).sum()
            n += 16
        return e / max(n, 1)

    best = None
    for (mvx, mvy) in uniq:
        blk = mc_luma_block(ref.luma_planes, px * 4 + mvx, py * 4 + mvy,
                            16, 16, w_img, h_img).astype(np.uint8)
        cost = side_match(blk)
        if best is None or cost < best[0]:
            best = (cost, (mvx, mvy), blk)
    _cost, (mvx, mvy), blk = best
    Y[py:py + 16, px:px + 16] = blk
    ch = U.shape[0] // mb_h                 # 8 at 4:2:0, 16 at 4:2:2
    cy, cx = mby * ch, mbx * 8
    yscale = 2 if ch == 16 else 1           # 4:2:2: the luma's vertical MV
    for plane, pad in zip((U, V), ref.chroma_pad):
        plane[cy:cy + ch, cx:cx + 8] = mc_chroma_block(
            pad, cx * 8 + mvx, cy * 8 + mvy * yscale, 8, ch, U.shape[1],
            U.shape[0]).astype(np.uint8)
    pic.mv[addr] = (mvx, mvy)
    pic.ref_idx[addr] = 0
    pic.mb_class[addr] = 0                  # MB_INTER
