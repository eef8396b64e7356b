"""Explicit GOP structure strings and the explicit sequence coder,
twin of jm_tpu/encoder/gop.py: GopEntry and parse_explicit_hierarchy
(lencod/src/explicit_gop.c interpret_gop_structure:61), SeqEntry,
parse_explicit_seq_file and encode_explicit_seq (lencod/src/
explicit_seq.c ReadExplicitSeqFile:259, ReadFrameData:191).

Each coded entry is ``<B><display_no><r|e><qp_offset>[T<layer>]``: e.g.
``b2r0b0e1b1e1b3e1`` codes the middle B first as a reference ('r'), then
the leaves as expendable ('e') at QP + 1. display_no indexes the B
positions between two anchors (0..num_b - 1); the optional T<layer> tag
is kept but the order is the string's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

_ENTRY = re.compile(r"([bBpPiI])(\d+)([reRE])(-?\d+)(?:[tT](\d+))?")


@dataclass
class GopEntry:
    slice_type: str      # 'B' (P / I enhancement entries are refused)
    display_no: int
    as_ref: bool
    qp_offset: int
    layer: int = 0


def parse_explicit_hierarchy(s: str) -> list[GopEntry]:
    """The entries of an ExplicitHierarchyFormat string; ValueError for a
    malformed string, a P or I entry, or a repeated display_no."""
    out = []
    pos = 0
    s = s.strip().strip('"')
    while pos < len(s):
        m = _ENTRY.match(s, pos)
        if not m:
            raise ValueError(
                f"ExplicitHierarchyFormat parse error at '{s[pos:]}'")
        st, dno, ref, dqp, tl = m.groups()
        if st.upper() != "B":
            raise ValueError(
                "only B entries are supported in the enhancement GOP")
        out.append(GopEntry("B", int(dno), ref.lower() == "r", int(dqp),
                            int(tl) if tl else 0))
        pos = m.end()
    seen = [e.display_no for e in out]
    if len(set(seen)) != len(seen):
        raise ValueError("duplicate display_no in ExplicitHierarchyFormat")
    return out


@dataclass
class SeqEntry:
    seq_number: int          # display index within one cycle
    slice_type: str          # "I" | "P" | "B"
    idr: bool
    reference: int           # nal_ref_idc (0: disposable)


def parse_explicit_seq_file(text: str) -> list:
    """The entries of an explicit sequence information file: the
    ``Sequence { FrameCount : N  Frame { SeqNumber / SliceType /
    IDRPicture / Reference } ... }`` dialect of explicit_seq.c, the
    fields of a Frame block in any order. ValueError for a Frame without
    SeqNumber or SliceType, a file without Frames, or a first picture
    that is not a reference I picture. FrameCount is read and not held
    to the number of Frames (the entries cycle over the clip)."""
    toks = text.replace("{", " { ").replace("}", " } ").split()
    entries = []
    cur = None

    def flush():
        if cur is not None:
            if "SeqNumber" not in cur or "SliceType" not in cur:
                raise ValueError(
                    "explicit seq file: Frame needs SeqNumber + SliceType")
            entries.append(SeqEntry(int(cur["SeqNumber"]),
                                    str(cur["SliceType"]).upper(),
                                    bool(int(cur.get("IDRPicture", 0))),
                                    int(cur.get("Reference", 3))))

    i = 0
    while i < len(toks):
        t = toks[i]
        if t == "Frame":
            flush()
            cur = {}
            i += 1
        elif t in ("Sequence", "{", "}"):
            i += 1
        elif i + 2 < len(toks) and toks[i + 1] == ":":
            if t != "FrameCount" and cur is not None:
                cur[t] = toks[i + 2]
            i += 3
        else:
            i += 1
    flush()
    if not entries:
        raise ValueError("explicit seq file: no Frame entries")
    if entries[0].slice_type != "I":
        raise ValueError("first coded picture must be Intra "
                         "(explicit_seq.c ParseSliceType)")
    if entries[0].reference == 0:
        raise ValueError("first coded picture must be a reference")
    return entries


def encode_explicit_seq(enc, frames, entries) -> list:
    """Drive the port's Encoder (encoder/encoder.py) through an explicit
    coding schedule, as jm_tpu's encode_explicit_seq: the entries cycle
    over the clip (coding index ci takes entry ci % len(entries), display
    seq_number + (ci // len(entries)) * span, span the largest
    seq_number + 1) until a display index falls past the clip. An I or P
    entry codes an anchor (IDRPicture makes an I an IDR); a B entry a B
    picture between the nearest coded reference pictures before and
    after it in display order (ValueError when one side has none), a
    reference B unless Reference is 0. Returns the payloads in coding
    order."""
    frames = list(frames)
    n = len(frames)
    span = max(e.seq_number for e in entries) + 1
    coded = {}                          # display -> reference Picture
    payloads = []
    ci = 0
    while True:
        e = entries[ci % len(entries)]
        disp = e.seq_number + (ci // len(entries)) * span
        if disp >= n:
            break
        frame = tuple(np.asarray(p, np.uint8) for p in frames[disp])
        if e.slice_type in ("I", "P"):
            enc.display_idx = max(enc.display_idx, disp + 1)
            payloads.append(enc._emit_anchor(
                frame, disp, force={"intra": e.slice_type == "I",
                                    "idr": e.idr}))
            coded[disp] = enc.results[-1]["frame"]
        elif e.slice_type == "B":
            below = [d for d in coded if d < disp]
            above = [d for d in coded if d > disp]
            if not below or not above:
                raise ValueError(
                    f"explicit seq: B at display {disp} lacks coded "
                    "references on both sides")
            payloads.append(enc._emit_b(
                frame, disp, coded[max(below)], coded[min(above)],
                as_ref=e.reference > 0))
            if e.reference > 0:
                coded[disp] = enc.results[-1]["frame"]
        else:
            raise ValueError(f"explicit seq: slice type {e.slice_type}")
        ci += 1
    return payloads
