"""Bitstream writing: bit packing and NAL/Annex-B framing."""
