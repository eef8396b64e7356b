"""Explicit GOP structure strings, twin of jm_tpu/encoder/gop.py's
GopEntry and parse_explicit_hierarchy (lencod/src/explicit_gop.c
interpret_gop_structure:61).

Each coded entry is ``<B><display_no><r|e><qp_offset>[T<layer>]``: e.g.
``b2r0b0e1b1e1b3e1`` codes the middle B first as a reference ('r'), then
the leaves as expendable ('e') at QP + 1. display_no indexes the B
positions between two anchors (0..num_b - 1); the optional T<layer> tag
is kept but the order is the string's.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

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
