"""rtp_loss twin, the port's copy of jm_tpu/tools/rtp_loss.py: drop RTP
packets from a JM RTP dump file (host only: it rewrites the container
and decodes nothing).

    python -m jm_tpu_torch.tools.rtp_loss input_file output_file
        loss_percent [keep_leading_packets] [--seed N]

Parity with rtp_loss/rtp_loss.cpp:21 (keep_packet) and main: keeps the
first N packets verbatim, then drops each subsequent packet with the given
probability. The fault-injection tool for the decoder's concealment
(H264Decoder(conceal_mode=1 / 2)). --seed (an extension) makes runs
reproducible: the same seed drops the packets jm_tpu's tool drops.
"""

from __future__ import annotations

import random
import struct
import sys

from ..bitstream.rtp import compose_packet, read_rtp_dump


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seed = None
    if "--seed" in argv:
        i = argv.index("--seed")
        seed = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) not in (3, 4):
        print("This tool allows dropping RTP packets from the given input "
              "file.\nUsage: rtp_loss input_file output_file loss_percent "
              "<keep_leading_packets> [--seed N]")
        return -1
    loss_percent = int(argv[2])
    keep_leading = int(argv[3]) if len(argv) == 4 else 0
    rng = random.Random(seed)
    try:
        data = open(argv[0], "rb").read()
    except OSError:
        print(f"cannot open H.264 packet file {argv[0]} for reading")
        return -2
    out = bytearray()
    for no, p in enumerate(read_rtp_dump(data)):
        keep = (no < keep_leading
                or loss_percent <= 0
                or (loss_percent <= 100
                    and rng.randrange(100) >= loss_percent))
        if keep:
            pkt = compose_packet(p)
            out += struct.pack("<Ii", len(pkt), p.timestamp) + pkt
        else:
            print(f"lost packet #{no}")
    with open(argv[1], "wb") as fh:
        fh.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
