"""The MB bit count of basic-unit rate control, twin of
jm_tpu/encoder/rdo.py count_mb_bits (:68-83) without an RD tier: the
marginal bits of one decided MB, serialized alone by the Python CAVLC
MBWriter from the slice QP of the picture's QP at that MB (a skipped MB
costs the skip run it leaves). As in jm_tpu, a CABAC stream's MBs are
counted in CAVLC bits too: only its RD tiers count arithmetic-coded
bits, and the port has none of them.
"""

from __future__ import annotations

from ..bitstream.bitwriter import BitWriter
from .syntax import MBWriter


def count_mb_bits(pic, sps, pps, qp: int, addr: int, slice_type,
                  num_ref: int) -> int:
    """The bits of MB addr of pic (PictureData) in a slice of slice_type
    whose running QP is qp, with num_ref active list-0 references."""
    bw = BitWriter()
    w = MBWriter(bw, pic, sps, pps, qp)
    w.write_mb(addr, slice_type, num_ref)
    w.finish(slice_type)
    return bw.bitpos
