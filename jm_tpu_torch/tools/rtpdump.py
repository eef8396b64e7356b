"""rtpdump twin, the port's copy of jm_tpu/tools/rtpdump.py: print RTP
packet headers from a JM RTP dump file (host only: it reads the
container and decodes nothing).

    python -m jm_tpu_torch.tools.rtpdump input_file

Parity with rtpdump/rtpdump.cpp:14 (main): same fields, same per-packet
report, for files produced by lencod OutFileMode=1 or the port's lencod
(jm_tpu_torch/tools/lencod.py).
"""

from __future__ import annotations

import sys

from ..bitstream.rtp import read_rtp_dump


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("This tool displays information about the RTP packets in the "
              "given input file.\nUsage: rtpdump input_file")
        return -1
    try:
        data = open(argv[0], "rb").read()
    except OSError:
        print(f"cannot open H.264 packet file {argv[0]} for reading")
        return -2
    for no, p in enumerate(read_rtp_dump(data)):
        print(f"\n\npacket #{no:4d} containing {len(p.payload) + 12:5d} bytes")
        print("Version (V): 2")
        print("Padding (P): 0")
        print("Extension (X): 0")
        print("CSRC count (CC): 0")
        print(f"Marker bit (M): {p.marker}")
        print(f"Payload Type (PT): {p.pt}")
        print(f"Sequence Number: {p.seq}")
        print(f"Timestamp: {p.timestamp}")
        print(f"SSRC: {p.ssrc}")
        print(f"First Byte: 0x{p.payload[0]:x}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
