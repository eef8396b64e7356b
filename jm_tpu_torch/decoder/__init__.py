"""The port's H.264 decoder: Baseline CAVLC I/P streams, 4:2:0, 8-bit,
frame pictures. Entry points: ``decoder.H264Decoder`` and
``decoder.decode_file``."""
