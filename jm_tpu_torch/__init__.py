"""PyTorch / CUDA port of the jm_tpu H.264 encoder.

The IPPP CAVLC 4:2:0 fast RD encode runs as tensor stages (ops/) on the
card, with the in-loop deblock as hand-written CUDA kernels (kernels/);
the host side (bitstream/, common/, encoder/) is numpy and pure Python.
Entry point: ``jm_tpu_torch.encoder.Encoder``."""
