"""Leaky-bucket (HRD) parameter computation (the port's own copy of
jm_tpu/encoder/leaky_bucket.py).

Capability parity with lencod/src/leaky_bucket.c (calc_buffer:198,
get_LeakyBucketRate:42, write_buffer:119) — same algorithm over the
per-picture bit curve: for each candidate rate R, simulate the decoder
buffer to find the minimal buffer size B and initial fullness F, then
emit (R, B, F) triples as big-endian 32-bit words (PutBigDoubleWord
format, so the file is interchangeable with the reference's
leakybucketparam.cfg).
"""

from __future__ import annotations

import struct


def calc_buffer(bits_per_frame: list[int], frame_rate: float,
                n_buckets: int = 8, rates: list[int] | None = None
                ) -> list[tuple[int, int, int]]:
    n = len(bits_per_frame)
    if n == 0:
        return []
    total = sum(bits_per_frame)
    avg = total / n                       # bits/frame
    if rates is None:
        rates = []
        for i in range(n_buckets):
            if i == 0:
                rates.append(int(avg * frame_rate))
            else:
                rates.append(int(rates[-1] + (avg / 4) * frame_rate))
    rates = sorted(rates)

    out = []
    max_buffer = int(avg * 20)
    for r in rates:
        chan = int(r / frame_rate)        # bits/frame
        # pass 1: minimal buffer size with full initial fullness
        level = max_buffer
        min_b = max_buffer
        frame_index = 0
        for i, b in enumerate(bits_per_frame):
            level -= b
            if level < min_b:
                min_b = level
                frame_index = i
            level = min(level + chan, max_buffer)
        actual = max_buffer - min_b
        # pass 2: minimal initial fullness for that buffer size
        init = bits_per_frame[0]
        level = init
        for i in range(frame_index + 1):
            level -= bits_per_frame[i]
            if level < 0:
                init -= level
                level = 0
            level += chan
            if level > actual:
                break
        out.append((int(r), int(actual), int(init)))
    return out


def write_buffer(path: str, buckets: list[tuple[int, int, int]]) -> None:
    """leakybucketparam.cfg: N then R/B/F triples, 32-bit big-endian."""
    with open(path, "wb") as fh:
        fh.write(struct.pack(">I", len(buckets)))
        for r, b, f in buckets:
            fh.write(struct.pack(">III", r, b, f))


def read_buffer(path: str) -> list[tuple[int, int, int]]:
    data = open(path, "rb").read()
    (n,) = struct.unpack_from(">I", data, 0)
    return [struct.unpack_from(">III", data, 4 + 12 * i) for i in range(n)]
