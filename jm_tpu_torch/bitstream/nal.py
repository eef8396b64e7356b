"""NAL unit framing: NAL unit types, Annex-B demux (decoder) and mux
(encoder) with the MVC extension header of NAL units 14 / 20 (spec
H.7.3.1.1), EBSP <-> RBSP emulation prevention (ldecod/src/annexb.c
get_annex_b_NALU, ldecod/src/nal.c EBSPtoRBSP, lencod/src/nal.c
RBSPtoEBSP, lencod/src/annexb.c WriteAnnexbNALU). Start codes are
located with numpy scans over the whole buffer; the emulation-prevention
escapes run in the port's C++ runtime (jm_tpu_torch/native), with the
Python twins ``py_ebsp_to_rbsp`` / ``py_rbsp_to_ebsp``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from .. import native


class NalUnitType(enum.IntEnum):
    SLICE = 1          # coded slice, non-IDR
    DPA = 2
    DPB = 3
    DPC = 4
    IDR = 5            # coded slice, IDR
    SEI = 6
    SPS = 7
    PPS = 8
    AUD = 9
    EOSEQ = 10
    EOSTREAM = 11
    FILLER = 12
    SPS_EXT = 13
    PREFIX = 14
    SUBSET_SPS = 15
    AUX_SLICE = 19
    SLICE_EXT = 20


@dataclass
class NalUnit:
    nal_ref_idc: int
    nal_unit_type: int
    rbsp: bytes                 # emulation prevention removed, header stripped
    # MVC extension header fields (nal_unit_type 14/20), None otherwise
    mvc_ext: dict | None = None
    # RTP transport: missing sequence numbers right before this unit
    # (ldecod's nalu->lost_packets); always 0 for Annex-B input
    lost_before: int = 0


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation_prevention_three_byte (00 00 03 -> 00 00)."""
    return native.load().ebsp_to_rbsp(ebsp)


def py_ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Python twin of ebsp_to_rbsp. The 03 ends the zero run, so
    candidates never overlap: all are removed."""
    buf = np.frombuffer(ebsp, dtype=np.uint8)
    if len(buf) < 3:
        return ebsp
    z = buf == 0
    cand = np.flatnonzero((buf[2:] == 3) & z[1:-1] & z[:-2]) + 2
    if len(cand) == 0:
        return ebsp
    return np.delete(buf, cand).tobytes()


def _parse_nal_header(ebsp: bytes) -> NalUnit:
    hdr = ebsp[0]
    if hdr & 0x80:
        raise ValueError("forbidden_zero_bit set")
    ntype = hdr & 0x1F
    mvc_ext = None
    body = ebsp[1:]
    if ntype in (NalUnitType.PREFIX, NalUnitType.SLICE_EXT):
        # 3-byte MVC / SVC extension header (ldecod/src/nalu.c:156)
        ext = int.from_bytes(ebsp[1:4], "big")
        if not (ext >> 23) & 1:          # svc_extension_flag
            mvc_ext = {
                "non_idr_flag": (ext >> 22) & 1,
                "priority_id": (ext >> 16) & 0x3F,
                "view_id": (ext >> 6) & 0x3FF,
                "temporal_id": (ext >> 3) & 7,
                "anchor_pic_flag": (ext >> 2) & 1,
                "inter_view_flag": (ext >> 1) & 1,
            }
        body = ebsp[4:]
    return NalUnit((hdr >> 5) & 3, ntype, ebsp_to_rbsp(body), mvc_ext)


def split_annexb(data: bytes) -> list[NalUnit]:
    """Split an Annex-B byte stream into NAL units."""
    buf = np.frombuffer(data, dtype=np.uint8)
    z = buf == 0
    sc3 = np.flatnonzero(z[:-2] & z[1:-1] & (buf[2:] == 1))   # 00 00 01 at i
    units = []
    starts = sc3 + 3                      # first payload byte
    ends = list(sc3[1:]) + [len(buf)]     # payload runs to next start code
    for s, e in zip(starts, ends):
        # trailing zeros belong to the next start code's prefix (or are
        # trailing_zero_8bits)
        while e > s and buf[e - 1] == 0:
            e -= 1
        if e > s:
            units.append(_parse_nal_header(buf[s:e].tobytes()))
    return units


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation prevention bytes: any 00 00 0x (x<=3) gets 03."""
    return native.load().rbsp_to_ebsp(rbsp)


def py_rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Python twin of rbsp_to_ebsp."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def mvc_ext_bytes(non_idr_flag: int, view_id: int, anchor_pic_flag: int,
                  inter_view_flag: int, priority_id: int = 0,
                  temporal_id: int = 0) -> bytes:
    """3-byte nal_unit_header_mvc_extension (spec H.7.3.1.1; the inverse
    of _parse_nal_header's MVC branch). svc_extension_flag = 0."""
    ext = ((non_idr_flag << 22) | (priority_id << 16) | (view_id << 6)
           | (temporal_id << 3) | (anchor_pic_flag << 2)
           | (inter_view_flag << 1) | 1)
    return ext.to_bytes(3, "big")


def annexb_bytes(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
                 long_startcode: bool = True,
                 mvc_ext: bytes | None = None) -> bytes:
    """Frame one NALU for an Annex-B stream. mvc_ext: the 3 extension
    header bytes for nal_unit_type 14/20 (part of the NAL header, so
    they precede the payload's emulation prevention)."""
    hdr = bytes([(nal_ref_idc << 5) | nal_unit_type])
    if mvc_ext is not None:
        hdr += mvc_ext
    sc = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    return sc + hdr + rbsp_to_ebsp(rbsp)
