"""RTP packetization (JM OutFileMode=1 dump-file format; the port's own
copy of jm_tpu/bitstream/rtp.py).

Capability parity with the reference RTP path (lencod/src/rtp.c
WriteRTPNALU:173 / ComposeRTPPacket:60 / RTPUpdateTimestamp:250,
ldecod/src/rtp.c GetRTPNALU:154 / RTPReadPacket / DecomposeRTPpacket:239)
and the dump-file container used by rtpdump/rtp_loss
(rtpdump/rtpdump.cpp:36-47): records of

    uint32 LE packet_size | int32 LE time | packet bytes

where each packet is a 12-byte RTP header (V=2, PT=105, big-endian
seq/timestamp, SSRC 0x12345678) followed by one complete NAL unit
(header byte + EBSP). Sequence-number gaps on read are surfaced as
``lost_before`` so the decoder's error-resilience path can react the way
the reference's ``nalu->lost_packets`` does.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .nal import NalUnit, _parse_nal_header, rbsp_to_ebsp

H264_PAYLOAD_TYPE = 105          # lencod/inc/rtp.h:25
H264_SSRC = 0x12345678           # lencod/inc/rtp.h:26
RTP_TR_TIMESTAMP_MULT = 1000     # lencod/inc/rtp.h:27
MAX_RTP_PACKET_SIZE = 65536 - 28


@dataclass
class RtpPacket:
    seq: int
    timestamp: int
    marker: int
    payload: bytes               # NAL header byte + EBSP
    ssrc: int = H264_SSRC
    pt: int = H264_PAYLOAD_TYPE


def compose_packet(p: RtpPacket) -> bytes:
    """12-byte RTP header + payload (rtp.c ComposeRTPPacket:60)."""
    b0 = 0x80                    # V=2, P=0, X=0, CC=0
    b1 = ((p.marker & 1) << 7) | (p.pt & 0x7F)
    return struct.pack(">BBHII", b0, b1, p.seq & 0xFFFF,
                       p.timestamp & 0xFFFFFFFF, p.ssrc) + p.payload


def parse_packet(pkt: bytes) -> RtpPacket:
    """Inverse of compose_packet (ldecod/src/rtp.c DecomposeRTPpacket:239);
    validates the header-consistency rules the reference enforces."""
    if len(pkt) < 13:
        raise ValueError("RTP packet shorter than header + 1 payload byte")
    b0, b1, seq, ts, ssrc = struct.unpack(">BBHII", pkt[:12])
    if (b0 >> 6) != 2:
        raise ValueError(f"RTP version {(b0 >> 6)} != 2")
    if b0 & 0x3F:                # P, X, CC must be zero in JM streams
        raise ValueError("unexpected RTP padding/extension/CSRC")
    return RtpPacket(seq=seq, timestamp=ts, marker=(b1 >> 7) & 1,
                     payload=pkt[12:], ssrc=ssrc, pt=b1 & 0x7F)


class RtpDumpWriter:
    """Accumulates NALUs into the JM RTP dump-file byte stream."""

    def __init__(self):
        self.seq = 0
        self.timestamp = 0
        self._old_tr = -1
        self.buf = bytearray()

    def update_timestamp(self, tr: int) -> None:
        """RTPUpdateTimestamp (lencod/src/rtp.c:250): advance the 90kHz-ish
        clock by the TR delta (wrap at 256; deltas <= -10 are wraps, small
        negative deltas are B-picture reordering)."""
        if self._old_tr == -1:
            self.timestamp = 0
            self._old_tr = 0
            return
        delta = tr - self._old_tr
        if delta < -10:
            delta += 256
        self._old_tr = tr
        self.timestamp += delta * RTP_TR_TIMESTAMP_MULT

    def write_nalu(self, nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
                   marker: int = 0) -> None:
        first = bytes([((nal_ref_idc & 3) << 5) | (nal_unit_type & 0x1F)])
        payload = first + rbsp_to_ebsp(rbsp)
        if len(payload) + 12 > MAX_RTP_PACKET_SIZE:
            raise ValueError("NALU exceeds maximum RTP packet size")
        pkt = compose_packet(RtpPacket(self.seq, self.timestamp, marker,
                                       payload))
        # dump record: uint32 LE size, int32 LE time, packet
        self.buf += struct.pack("<Ii", len(pkt), self.timestamp) + pkt
        self.seq = (self.seq + 1) & 0xFFFF

    def getvalue(self) -> bytes:
        return bytes(self.buf)


def read_rtp_dump(data: bytes) -> list[RtpPacket]:
    """Parse a dump file into packets (rtp_loss/rtpdump record walk)."""
    out, off = [], 0
    n = len(data)
    while off + 8 <= n:
        size, _t = struct.unpack_from("<Ii", data, off)
        off += 8
        if off + size > n:
            raise ValueError("truncated RTP dump record")
        out.append(parse_packet(data[off:off + size]))
        off += size
    return out


def split_rtp(data: bytes) -> list[NalUnit]:
    """Dump file -> NAL units, with per-unit ``lost_before`` = number of
    missing RTP sequence numbers immediately preceding it (the reference's
    nalu->lost_packets, ldecod/src/rtp.c:183-190)."""
    units = []
    old_seq = None
    for p in read_rtp_dump(data):
        u = _parse_nal_header(p.payload)
        u.lost_before = 0 if old_seq is None else (p.seq - old_seq - 1) & 0xFFFF
        old_seq = p.seq
        units.append(u)
    return units


def annexb_to_rtp(annexb: bytes) -> bytes:
    """Re-containerize an Annex-B stream as a JM RTP dump file, preserving
    the EBSP bytes exactly. Marker bit follows the reference rule (long
    startcode => marker, lencod/src/rtp.c:201); the timestamp advances one
    TR tick per coded picture — a slice NALU with first_mb_in_slice == 0
    opens a new access unit (multi-slice/FMO pictures share one TR,
    matching JM's per-picture RTPUpdateTimestamp)."""
    import numpy as np
    buf = np.frombuffer(annexb, dtype=np.uint8)
    z = buf == 0
    sc3 = np.flatnonzero(z[:-2] & z[1:-1] & (buf[2:] == 1))
    w = RtpDumpWriter()
    starts = sc3 + 3
    ends = list(sc3[1:]) + [len(buf)]
    frame_no = -1
    for s, e in zip(starts, ends):
        long_sc = s >= 4 and buf[s - 4] == 0
        while e > s and buf[e - 1] == 0:
            e -= 1
        if e <= s:
            continue
        payload = buf[s:e].tobytes()          # NAL header byte + EBSP
        # first_mb_in_slice == 0 <=> first RBSP bit set (ue(v) == 0)
        if (payload[0] & 0x1F in (1, 5) and len(payload) > 1
                and payload[1] & 0x80):
            frame_no += 1
        w.update_timestamp(max(frame_no, 0) & 0xFF)
        pkt = compose_packet(RtpPacket(w.seq, w.timestamp,
                                       1 if long_sc else 0, payload))
        w.buf += struct.pack("<Ii", len(pkt), w.timestamp) + pkt
        w.seq = (w.seq + 1) & 0xFFFF
    return w.getvalue()


def rtp_to_annexb(data: bytes) -> bytes:
    """Dump file -> Annex-B stream (for feeding the stock decoder path)."""
    out = bytearray()
    for p in read_rtp_dump(data):
        out += b"\x00\x00\x00\x01" if p.marker else b"\x00\x00\x01"
        out += p.payload
    return bytes(out)
