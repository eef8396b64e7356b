"""The port's H.264 decoder: I/P streams, CAVLC or CABAC, 4:2:0, 8-bit,
frame pictures. Entry points: ``decoder.H264Decoder`` and
``decoder.decode_file``."""
