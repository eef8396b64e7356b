"""Syntax-element trace tool, the port's copy of jm_tpu/tools/trace.py
(the JM TRACE facility), over the port's decoder; on the card unless
trace_stream / main are given device="cpu".

The reference, built with -DTRACE (lencod/inc/defines.h:25, trace strings
emitted in vlc.c:72 and ldecod's equivalents), writes `trace_dec.txt`
lines of the form

    @<bitpos>  <label>  <bit pattern> ( <value>)

This module reproduces the decoder-side trace for the port's parser
WITHOUT instrumenting any parse code: during a traced decode, the
`BitReader` bound inside decoder/parset.py, decoder/header.py and
decoder/sei.py is swapped for `TraceBitReader`, which logs every
primitive read (u/ue/se/te/flag) with its bit offset, width, value and
the calling parse function (the element label). Because the CAVLC
slice-data parser keeps reading from the header's reader, whole-slice
CAVLC element streams are traced too. CABAC slice payloads are not
traced: the CABAC engine takes only the native reader, so the parse of
a CABAC slice stops after its header ("!! parse stopped"), as jm_tpu's
does.

The labels are jm_tpu's: the port's reading helpers that jm_tpu does not
have (``_HELPERS``) are skipped, so that their caller's name shows, and
an 8-bit I_PCM MB's samples are read one u(8) at a time during a trace
(the port reads them as one block otherwise), as jm_tpu's parser reads
them.

`diff_traces` aligns two traces -- one version against another, or
against a JM trace_dec.txt -- on bit position/value and reports the first
divergence: where an entropy desync begins.

CLI:
    python -m jm_tpu_torch.tools.trace stream.264 [max_nalus] > trace.txt
    python -m jm_tpu_torch.tools.trace --diff trace_a.txt trace_b.txt
"""

from __future__ import annotations

import re
import sys

import numpy as np

from ..bitstream.bitreader import PyBitReader

# the port's reading helpers that jm_tpu reads inline: a read inside one
# of them is labelled with its caller's name (a B MB's mvds thus with
# b_slice.read_part_mvd, jm_tpu's helper of that name)
_HELPERS = frozenset(("_read_mmco", "read_pcm_samples", "_parse_slice_mbs",
                      "_fill_mv", "_read_inter_residual", "parse_b_motion",
                      "read_ref", "read_b_ref", "read_b_mvd",
                      "_read_b_subs"))


class TraceBitReader(PyBitReader):
    """BitReader logging every primitive read as
    (bitpos, width, kind, label, value). The label is the nearest
    parse-layer caller function name (parse_sps -> SPS fields, _read_rplm
    -> reorder commands, ...). Subclasses the Python reader (the native
    reader is not subclassable; tracing trades speed for
    observability)."""

    __slots__ = ("_depth",)
    _log: list = []          # class-level sink installed by trace_stream

    def __init__(self, data) -> None:
        super().__init__(data)
        self._depth = 0

    def _label(self) -> str:
        f = sys._getframe(3)
        while f is not None and (
                f.f_code.co_filename.endswith(("bitreader.py", "trace.py"))
                or f.f_code.co_name in _HELPERS):
            f = f.f_back
        return f.f_code.co_name if f is not None else "?"

    def _traced(self, kind, parent, *a):
        pos = self.pos
        self._depth += 1
        try:
            v = parent(*a)
        finally:
            self._depth -= 1
        if self._depth == 0:
            TraceBitReader._log.append(
                (pos, self.pos - pos, kind, self._label(), v))
        return v

    def u(self, n: int) -> int:
        return self._traced("u", super().u, n)

    def flag(self) -> int:
        return self._traced("flag", super().flag)

    def ue(self) -> int:
        return self._traced("ue", super().ue)

    def se(self) -> int:
        return self._traced("se", super().se)

    def te(self, rng: int) -> int:
        return self._traced("te", super().te, rng)


def _read_pcm_samples(br, sps):
    """mb_parse.read_pcm_samples with every sample one u(n) read."""
    bdl, bdc = sps.bit_depth_luma, sps.bit_depth_chroma
    dtl = np.uint8 if bdl == 8 else np.uint16
    dtc = np.uint8 if bdc == 8 else np.uint16
    luma = np.array([br.u(bdl) for _ in range(256)], dtl)
    chroma = np.array([br.u(bdc) for _ in range(128)], dtc)
    return luma.reshape(16, 16), chroma.reshape(2, 8, 8)


def _patch_modules(cls):
    from ..decoder import header as h
    from ..decoder import mb_parse as mp
    from ..decoder import parset as ps
    from ..decoder import sei
    saved = (ps.BitReader, h.BitReader, sei.BitReader, mp.read_pcm_samples,
             mp.MBParser._parse_native)
    ps.BitReader = h.BitReader = sei.BitReader = cls
    mp.read_pcm_samples = _read_pcm_samples
    # the native slice parser consumes whole slices without per-element
    # reads; tracing needs the Python parse loop
    mp.MBParser._parse_native = lambda self: False
    return saved


def _restore_modules(saved):
    from ..decoder import header as h
    from ..decoder import mb_parse as mp
    from ..decoder import parset as ps
    from ..decoder import sei
    (ps.BitReader, h.BitReader, sei.BitReader, mp.read_pcm_samples,
     mp.MBParser._parse_native) = saved


def trace_stream(data: bytes, max_nalus: int | None = None,
                 device="cuda") -> str:
    """Decode an Annex-B stream on ``device`` with the tracing reader
    installed and render one JM-style line per primitive read, grouped
    per NALU."""
    from ..bitstream.nal import split_annexb
    from ..decoder.decoder import H264Decoder
    nal_types = {1: "slice", 5: "IDR", 6: "SEI", 7: "SPS", 8: "PPS",
                 9: "AUD", 15: "subsetSPS", 20: "sliceExt"}
    dec = H264Decoder(device=device)
    nalus = split_annexb(data)
    if max_nalus is not None:
        nalus = nalus[:max_nalus]
    out = []
    saved = _patch_modules(TraceBitReader)
    try:
        for k, nal in enumerate(nalus):
            out.append(f"== NALU {k}: type {nal.nal_unit_type} "
                       f"({nal_types.get(nal.nal_unit_type, '?')}), "
                       f"len {len(nal.rbsp) + 1}, nri {nal.nal_ref_idc}")
            TraceBitReader._log = log = []
            try:
                dec._handle_nal(nal)
            except Exception as e:          # truncated / unsupported tail
                out.append(f"!! parse stopped: {type(e).__name__}: {e}")
            for (pos, width, kind, fn, val) in log:
                out.append(f"@{pos:<7d}{fn}:{kind:<5s} "
                           f"{'x' * min(width, 24):>24s} ({val:7d})")
    finally:
        _restore_modules(saved)
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# trace diffing
# ---------------------------------------------------------------------------

# JM: "@24    SPS: seq_parameter_set_id    1 (  0)"
# ours: "@24     parse_sps:ue        x (      0)"
_LINE_RE = re.compile(r"^@(\d+)\s+(\S.*?)\s+([01x]+)\s+\(\s*(-?\d+)\)")


def parse_trace(text: str) -> list:
    """(bitpos, label, value) triples from either trace dialect."""
    out = []
    for line in text.splitlines():
        m = _LINE_RE.match(line.strip())
        if m:
            out.append((int(m.group(1)), m.group(2).strip(),
                        int(m.group(4))))
    return out


def diff_traces(a: str, b: str, context: int = 4) -> str:
    """First divergence between two traces aligned element-by-element on
    (bit position, value) -- exactly where an entropy desync begins."""
    ta, tb = parse_trace(a), parse_trace(b)
    n = min(len(ta), len(tb))
    for i in range(n):
        pa, la, va = ta[i]
        pb, lb, vb = tb[i]
        if pa != pb or va != vb:
            lines = [f"DIVERGE at element #{i}:",
                     f"  A: @{pa} {la} = {va}",
                     f"  B: @{pb} {lb} = {vb}",
                     "  context:"]
            for j in range(max(0, i - context), min(n, i + context)):
                mark = ">>" if j == i else "  "
                lines.append(
                    f"  {mark} A @{ta[j][0]:<6d} {ta[j][1][:36]:36s}"
                    f" {ta[j][2]:6d} | B @{tb[j][0]:<6d} "
                    f"{tb[j][1][:36]:36s} {tb[j][2]:6d}")
            return "\n".join(lines)
    if len(ta) != len(tb):
        return (f"traces agree for {n} elements, lengths differ "
                f"({len(ta)} vs {len(tb)})")
    return f"IDENTICAL ({n} elements)"


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--diff":
        a = open(argv[1], encoding="latin-1").read()
        b = open(argv[2], encoding="latin-1").read()
        print(diff_traces(a, b))
        return 0
    if not argv:
        print(__doc__)
        return 2
    data = open(argv[0], "rb").read()
    limit = int(argv[1]) if len(argv) > 1 else None
    sys.stdout.write(trace_stream(data, max_nalus=limit, device=device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
