"""Closed GOPs on the rows of a (dp, sp) mesh (jm_tpu/parallel/
gop_pipeline.py).

Frames depend only on the DPB, and an IDR empties it (lencod mbuffer.c
:1727 idr_memory_management), so closed GOPs are independent encodes.
encode_gops_parallel splits the sequence at the IntraPeriod boundaries,
encodes GOP g with its own Encoder on row g % n_dp of the mesh (its
first device; with sp_shards == n_sp the encoder's MB-row sharded step
runs over the whole row), and joins the payloads. The one state that crosses GOPs is
idr_pic_id, one increment per IDR (frame_num and POC restart at every
IDR), so the joined stream is byte-identical to the serial encode. One
process encodes every GOP in turn, as jm_tpu's does.
"""

from __future__ import annotations

from ..encoder.encoder import Encoder
from .mesh import make_mesh
from .sp_pipeline import make_sp_mesh


def split_gops(n_frames: int, intra_period: int):
    """Closed-GOP frame ranges [(start, stop), ...]."""
    if intra_period <= 0:
        return [(0, n_frames)]
    return [(s, min(s + intra_period, n_frames))
            for s in range(0, n_frames, intra_period)]


def encode_gops_parallel(frames, cfg, n_dp: int = 1, n_sp: int = 1,
                         devices=None):
    """Encode the closed GOPs of frames ((Y, U, V) in display order) over
    a (n_dp, n_sp) mesh of devices (every CUDA card torch sees when
    None). cfg: an EncoderConfig with intra_period > 0, num_b == 0 and
    rate control off (ValueError otherwise). Returns (the payload bytes,
    the per-frame results in display order)."""
    if cfg.intra_period <= 0:
        raise ValueError("GOP parallelism needs IntraPeriod > 0 "
                         "(closed GOPs)")
    if cfg.num_b or cfg.rc_enable:
        raise ValueError("GOP parallelism needs num_b == 0 and rate "
                         "control off (cross-GOP state)")
    rows = make_mesh(n_dp, n_sp, devices)
    payloads, results = [], []
    for gi, (s, e) in enumerate(split_gops(len(frames), cfg.intra_period)):
        row = rows[gi % n_dp]
        enc = Encoder(cfg, device=row[0])
        enc.idr_pic_id = gi % 65536       # the serial encode's state
        if n_sp > 1 and cfg.sp_shards == n_sp:
            enc._sp_mesh = make_sp_mesh(n_sp, row)
        payloads.append(b"".join(enc.encode_frame(*frames[i])
                                 for i in range(s, e)) + enc.flush())
        for r in sorted(enc.results, key=lambda r: r["disp"]):
            results.append(dict(r, disp=r["disp"] + s))
    return b"".join(payloads), results
