"""numpy host modules shared by the encoder stages."""
