"""Frame-level encoder and the host CAVLC serializer."""
