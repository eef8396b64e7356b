"""GOP-granular encoder job checkpoint / resume (the port's own copy of
jm_tpu/encoder/checkpoint.py; a checkpoint holds the port's objects and
is not read by jm_tpu, nor jm_tpu's by the port).

The reference has no encoder state checkpointing — its format-level resume
points are IDR pictures with SPS/PPS resend (lencod configfile.h:38
ResendSPS) and `StartFrame` input offsets (configfile.h:39). This module
adds the capability of resuming a job: a running encode
job can be snapshotted at any closed-GOP boundary (the next coded picture
is an IDR, so the DPB restarts empty and no reference pixels need saving)
and resumed later — on the same or a different host — producing a stream
byte-identical to the uninterrupted run.

What a checkpoint carries: the coded-order position (frame_idx,
display_idx, idr poc base, frame_num, idr_pic_id, uid counter), the rate
controller (full JVT-G012 state: Qp trace, MAD model, buffer fullness),
adaptive-rounding offsets, the intra-refresh permutation state, the
per-picture results without their recon, and the byte count of the emitted bitstream (the
resume truncates the output file there).

Elastic multi-host scheduling falls out: a scheduler can kill an encode at a
GOP edge and reschedule the remainder anywhere.

SECURITY: checkpoints are serialized with pickle and are TRUSTED INPUT
ONLY — load() executes code embedded in a malicious file. Only resume
from checkpoint paths your own jobs wrote (the same trust model as JM's
config/trace files, which are also read without isolation).
"""

from __future__ import annotations

import pickle

_FIELDS = ("frame_idx", "display_idx", "_idr_disp", "frame_num",
           "idr_pic_id", "_uid", "_refresh_pos")

MAGIC = b"JMTORCHCKPT1"


def checkpointable(enc) -> bool:
    """True when the NEXT picture starts a closed GOP (IDR): IPPP with a
    periodic intra cadence, at the cadence boundary."""
    cfg = enc.cfg
    return (cfg.num_b == 0 and cfg.num_views == 1
            and cfg.intra_period > 0
            and enc.frame_idx % cfg.intra_period == 0
            and not enc._pending)


def save(enc, path: str, bytes_written: int) -> None:
    """Snapshot `enc` at a closed-GOP boundary. Raises unless
    `checkpointable(enc)`."""
    if not checkpointable(enc):
        raise ValueError(
            "checkpoint requires a closed-GOP boundary (next picture IDR: "
            "num_b == 0, intra_period > 0, frame_idx multiple of it)")
    state = {k: getattr(enc, k) for k in _FIELDS if hasattr(enc, k)}
    state["results"] = [{k: v for k, v in r.items() if k != "frame"}
                        for r in enc.results]
    state["rc"] = enc.rc.__dict__.copy() if enc.rc is not None else None
    ar = getattr(enc, "_ar_state", None)
    state["_ar_state"] = ar
    state["_refresh_perm"] = getattr(enc, "_refresh_perm", None)
    state["bytes_written"] = bytes_written
    state["cfg"] = enc.cfg
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        pickle.dump(state, fh)


def load(path: str, device="cuda"):
    """Returns (encoder, frames_done, bytes_written): a fresh Encoder on
    device positioned to continue at the checkpointed GOP boundary."""
    from .encoder import Encoder
    with open(path, "rb") as fh:
        if fh.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path} is not a checkpoint of this encoder")
        state = pickle.load(fh)
    enc = Encoder(state["cfg"], device=device)
    for k in _FIELDS:
        if k in state:
            setattr(enc, k, state[k])
    enc.results = state["results"]
    if state["rc"] is not None and enc.rc is not None:
        enc.rc.__dict__.update(state["rc"])
    if state.get("_ar_state") is not None:
        enc._ar_state = state["_ar_state"]
    if state.get("_refresh_perm") is not None:
        enc._refresh_perm = state["_refresh_perm"]
    return enc, enc.frame_idx, state["bytes_written"]
