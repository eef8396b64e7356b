"""Command-line twins of the reference binaries, on the port's encoder and
decoder (on the card unless main is given device="cpu"):

  python -m jm_tpu_torch.tools.lencod -d encoder.cfg [-f more.cfg] [-p Name=Value]
  python -m jm_tpu_torch.tools.ldecod -d decoder.cfg | -i in.264 -o out.yuv [-r ref]

Parity targets: lencod/src/lencod.c main loop + report (image.c ReportI/P),
ldecod/src/ldecod.c + image.c find_snr, through jm_tpu/tools.
"""
