"""PyTorch / CUDA port of the jm_tpu H.264 encoder and decoder.

The IPPP CAVLC 4:2:0 fast RD encode and the P-picture decode run as
tensor stages (ops/) on the card, with the in-loop deblock as
hand-written CUDA kernels (kernels/); the host side (bitstream/,
common/, encoder/, decoder/) is numpy and Python, with its bit-serial
loops (the bit reader, the CABAC engine, the CAVLC serializer and
parser, the intra recon) in the port's C++ runtime (native/).
Entry points: ``jm_tpu_torch.encoder.Encoder``,
``jm_tpu_torch.decoder.decoder.H264Decoder``."""
