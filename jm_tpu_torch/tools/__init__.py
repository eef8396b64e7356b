"""Command-line twins of the reference binaries, on the port's encoder and
decoder (on the card unless main is given device="cpu"):

  python -m jm_tpu_torch.tools.lencod -d encoder.cfg [-f more.cfg] [-p Name=Value]
  python -m jm_tpu_torch.tools.ldecod -d decoder.cfg | -i in.264 -o out.yuv [-r ref]
  python -m jm_tpu_torch.tools.trace stream.264 [max_nalus] | --diff a b
  python -m jm_tpu_torch.tools.bdrate --input clip.yuv [--preset ...]
  python -m jm_tpu_torch.tools.rtpdump dump.rtp
  python -m jm_tpu_torch.tools.rtp_loss in.rtp out.rtp loss% [keep] [--seed N]

imgio.py (TIFF sequences, BT.601 RGB <-> YUV, resize) is numpy only;
rtpdump and rtp_loss read and write the RTP dump container on the host.

Parity targets: lencod/src/lencod.c main loop + report (image.c ReportI/P),
ldecod/src/ldecod.c + image.c find_snr, the JM TRACE facility, rtpdump
and rtp_loss, through jm_tpu/tools.
"""
