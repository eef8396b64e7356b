"""The port's H.264 decoder: I/P/B streams, CAVLC or CABAC, 4:2:0 or
4:2:2, 8-bit, frame pictures. Entry points: ``decoder.H264Decoder`` and
``decoder.decode_file``."""
