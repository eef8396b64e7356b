"""The md_low P step sharded by MB rows (jm_tpu/parallel/sp_pipeline.py).

ops/enc.p_frame_step (rd=False) distributed over the MB rows of one
picture: band i, mb_h / n MB rows, lives on mesh[i] (a list of
torch.devices, parallel/mesh.py). jm_tpu runs the band body under
shard_map on an 'sp' mesh and moves rows between neighbours with
ppermute; here one process drives the bands, and each ppermute is a copy
of the neighbour band's rows to this band's device (Tensor.to: a peer
copy between cards, a plain copy on one card). A device may hold more
than one band; they then run one after another. What a band reads
outside itself comes in as a halo:

  - reconstructed reference rows (HALO + 3 = 35 each way), from which
    the band builds its quarter-pel planes, the same rows as the whole
    picture's planes (the six-tap filter needs 3 more rows);
  - reconstructed chroma rows (HALO / 2 = 16 each way);
  - the integer 16x16 MVs of the MB row above (the approximate
    predictor's up / up-right neighbours);
  - the source row above (the intra-16 trigger's top neighbours).

A halo longer than a band (8 bands of one MB row: 16 rows against 35)
is gathered over several hops. Rows beyond the picture are its first or
last row (edge replication, as the planes' padding), so every band sees
the rows of the whole picture's planes and the stream is byte-identical
to the unsharded step's. The step needs mb_h % n == 0 and a search range
of 16 at most (a band's reads reach sr + 16 rows beyond it).
"""

from __future__ import annotations

import torch

from ..ops import enc as E
from ..ops.consts import PAD
from .mesh import take_devices

HALO = PAD          # luma rows each way a band's ME / MC may reach


def _shift_from_up(xs: list, mesh: list) -> list:
    """ppermute from the band above: band i gets xs[i - 1] on mesh[i],
    band 0 zeros."""
    return [torch.zeros_like(xs[0]) if i == 0 else xs[i - 1].to(d)
            for i, d in enumerate(mesh)]


def _shift_from_down(xs: list, mesh: list) -> list:
    """ppermute from the band below: the last band gets zeros."""
    n = len(mesh)
    return [torch.zeros_like(xs[-1]) if i == n - 1 else xs[i + 1].to(d)
            for i, d in enumerate(mesh)]


def _collect_top_halo(bands: list, mesh: list, rows: int, edge_fix: bool):
    """Rows [band_y0 - rows, band_y0) of the picture for each band, from the
    bands above (several hops when a band is shorter than rows). With
    edge_fix the rows above the picture are its row 0, else zeros. Each
    hop copies only the rows it hands on: all of a band, but at the last
    hop the rows taken."""
    n, band_h = len(bands), bands[0].shape[0]
    chunks = [[] for _ in bands]
    cur, remaining = bands, rows
    while remaining > 0:
        take = min(band_h, remaining)
        cur = _shift_from_up([c[c.shape[0] - take:] for c in cur], mesh)
        for i in range(n):
            chunks[i].append(cur[i])
        remaining -= take
    out = []
    for i in range(n):
        halo = torch.cat(chunks[i][::-1])                    # (rows, W)
        if edge_fix and i * band_h - rows < 0:
            y = i * band_h - rows + torch.arange(rows, device=halo.device)
            # jm_tpu carries row 0 along the hops; band i takes the same
            # row from band 0
            halo = torch.where((y < 0)[:, None], bands[0][0].to(mesh[i]),
                               halo)
        out.append(halo)
    return out


def _collect_bottom_halo(bands: list, mesh: list, rows: int, H: int,
                         edge_fix: bool):
    """Rows [band_y1, band_y1 + rows) of the picture (H rows) for each band,
    from the bands below; with edge_fix the rows below the picture are
    its last row."""
    n, band_h = len(bands), bands[0].shape[0]
    chunks = [[] for _ in bands]
    cur, remaining = bands, rows
    while remaining > 0:
        take = min(band_h, remaining)
        cur = _shift_from_down([c[:take] for c in cur], mesh)
        for i in range(n):
            chunks[i].append(cur[i])
        remaining -= take
    out = []
    for i in range(n):
        halo = torch.cat(chunks[i])
        if edge_fix and (i + 1) * band_h + rows > H:
            y = (i + 1) * band_h + torch.arange(rows, device=halo.device)
            halo = torch.where((y >= H)[:, None], bands[-1][-1].to(mesh[i]),
                               halo)
        out.append(halo)
    return out


def _extend_band(bands: list, mesh: list, rows: int, H: int,
                 edge_fix: bool = True) -> list:
    """Each (band_h, W) band -> (band_h + 2 rows, W) with its halo rows."""
    top = _collect_top_halo(bands, mesh, rows, edge_fix)
    bot = _collect_bottom_halo(bands, mesh, rows, H, edge_fix)
    return [torch.cat([t, b, d]) for t, b, d in zip(top, bands, bot)]


def _hpad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad the columns of a 2-D tensor by p each side."""
    w = x.shape[1]
    cols = torch.clamp(torch.arange(-p, w + p, device=x.device), 0, w - 1)
    return x[:, cols]


def _make_luma_planes_band(ext: torch.Tensor, rows_out: int, w: int):
    """Band twin of ops/enc.make_luma_planes: ext holds rows_out + 6 rows
    of the picture (the halo and 3 filter rows each side); returns the
    (4, rows_out, W + 2 PAD) uint8 [INT, B, H, J] planes, equal to the
    same rows of the whole picture's planes."""
    ext = _hpad(ext, PAD + 3).to(torch.int32)
    b1 = E._conv6_h(ext)
    B = torch.clamp((b1 + 16) >> 5, 0, 255)
    Hp = torch.clamp((E._conv6_v(ext) + 16) >> 5, 0, 255)
    J = torch.clamp((E._conv6_v(b1) + 512) >> 10, 0, 255)
    wp = w + 2 * PAD
    return torch.stack([ext[3:3 + rows_out, 3:3 + wp],
                        B[3:3 + rows_out, 1:1 + wp],
                        Hp[1:1 + rows_out, 3:3 + wp],
                        J[1:1 + rows_out, 1:1 + wp]]).to(torch.uint8)


def p_bands(mesh: list, origY, origU, origV, refY, refU, refV, qp: int,
            qpc: int, lam: int, lam4: int, *, mb_w: int, mb_h: int,
            sr: int) -> list:
    """The sharded step's band outputs: one dict of p_frame_step's md_low
    fields per band, on its device (jm_tpu _p_band under shard_map). The
    source and the reference's deblocked recon planes are whole pictures
    on any device; each band takes its rows."""
    n = len(mesh)
    mb_h_l = mb_h // n
    h, w = 16 * mb_h, 16 * mb_w
    band_h = 16 * mb_h_l
    hc = HALO // 2

    def split(x, rows):
        return [x[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(mesh)]

    oY, oU, oV = split(origY, band_h), split(origU, band_h // 2), \
        split(origV, band_h // 2)
    # the reference's plane set, band by band (prep_ref's twin over the
    # band and its halo)
    planes = [_make_luma_planes_band(e, band_h + 2 * HALO, w) for e in
              _extend_band(split(refY, band_h), mesh, HALO + 3, h)]
    padU = [_hpad(e, PAD) for e in
            _extend_band(split(refU, band_h // 2), mesh, hc, h // 2)]
    padV = [_hpad(e, PAD) for e in
            _extend_band(split(refV, band_h // 2), mesh, hc, h // 2)]
    y0 = [i * band_h - HALO for i in range(n)]
    int_mv = [E.me_int_sweep(oY[i], planes[i][0], mb_w, mb_h_l, sr, lam,
                             y0=y0[i], band_y0=i * band_h)[0]
              for i in range(n)]
    # the predictor reads the MB row above the band, the intra-16 trigger
    # the source row above it
    mv_up = _shift_from_up([m[:, 0].reshape(mb_h_l, mb_w, 2)[-1]
                            for m in int_mv], mesh)
    src_up = _shift_from_up([o[-1] for o in oY], mesh)
    return [E.p_step_after_sweep(
        oY[i], oU[i], oV[i], planes[i], padU[i], padV[i], int_mv[i], qp,
        qpc, lam, lam4, mb_w=mb_w, mb_h=mb_h_l, sr=sr, band_y0=i * band_h,
        y0=y0[i], y0c=i * band_h // 2 - hc, up_mv=mv_up[i],
        src_up=src_up[i], is_first=i == 0) for i in range(n)]


def make_sp_mesh(n: int, devices=None, device_type: str = "cuda") -> list:
    """The sp mesh: the first n of devices (every device of device_type
    when None); fewer raise ValueError."""
    return take_devices(n, devices, device_type)


def p_frame_step_sharded(mesh: list, origY, origU, origV, refY, refU, refV,
                         qp: int, qpc: int, lam: int, lam4: int, *,
                         mb_w: int, mb_h: int, sr: int) -> dict:
    """p_frame_step(rd=False) over the MB-row bands of mesh, from the
    reference's deblocked recon planes (each band builds its planes):
    the whole picture's fields, the bands concatenated on origY's
    device. Needs mb_h % len(mesh) == 0 and sr <= 16 (ValueError)."""
    n = len(mesh)
    if mb_h % n:
        raise ValueError(f"mb_h={mb_h} not divisible by {n} shards")
    if sr > 16:
        raise ValueError("sharded path supports SearchRange <= 16")
    bands = p_bands(mesh, origY, origU, origV, refY, refU, refV, qp, qpc,
                    lam, lam4, mb_w=mb_w, mb_h=mb_h, sr=sr)
    dev = origY.device
    return {k: torch.cat([b[k].to(dev) for b in bands]) for k in bands[0]}
