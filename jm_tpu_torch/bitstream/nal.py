"""NAL unit framing for the encoder: NAL unit types, RBSP -> EBSP
emulation prevention and Annex-B start codes (lencod/src/nal.c
RBSPtoEBSP, lencod/src/annexb.c WriteAnnexbNALU).
"""

from __future__ import annotations

import enum


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


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation prevention bytes: any 00 00 0x (x<=3) gets 03."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def annexb_bytes(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
                 long_startcode: bool = True) -> bytes:
    """Frame one NALU for an Annex-B stream."""
    hdr = bytes([(nal_ref_idc << 5) | nal_unit_type])
    sc = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    return sc + hdr + rbsp_to_ebsp(rbsp)
