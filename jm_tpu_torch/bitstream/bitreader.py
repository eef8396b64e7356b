"""MSB-first bit reader over an RBSP byte buffer, as in
jm_tpu/bitstream/bitreader.py: ``BitReader`` is the native reader of
the port's C++ runtime (jm_tpu_torch/native, jm_native.cpp), and
``PyBitReader`` its Python twin with the same API.

Fixed-length u(n), Exp-Golomb ue(v) / se(v) / te(v) and the
rbsp_trailing_bits query used by slice-data parsing (ldecod/src/vlc.c
u_v, ue_v, se_v; ldecod/src/nalu.c RBSPtoSODB). The buffer is kept as
``bytes`` (``data``), and the twin finds the position of the
rbsp_stop_one_bit once, at construction.
"""

from __future__ import annotations

from .. import native


def BitReader(data):
    """The default reader: a jm_torch_native.BitReader over a copy of
    ``data`` (the runtime is built at the first call)."""
    return native.load().BitReader(data)


class PyBitReader:
    """Reads bits MSB-first from a bytes-like RBSP buffer."""

    __slots__ = ("data", "nbits", "pos", "_stop")

    def __init__(self, data) -> None:
        self.data = bytes(data)
        self.nbits = len(self.data) * 8
        self.pos = 0  # absolute bit position
        stripped = self.data.rstrip(b"\x00")
        if stripped:
            b = stripped[-1]
            low = (b & -b).bit_length() - 1         # lowest set bit, LSB 0
            self._stop = (len(stripped) - 1) * 8 + (7 - low)
        else:
            self._stop = -1

    # -- fixed length ------------------------------------------------------

    def u(self, n: int) -> int:
        """Read n bits as an unsigned integer."""
        if n == 0:
            return 0
        pos = self.pos
        if pos + n > self.nbits:
            raise EOFError(f"bitreader overrun: need {n} bits at {pos}/{self.nbits}")
        byte0 = pos >> 3
        nbytes = ((pos & 7) + n + 7) >> 3
        acc = int.from_bytes(self.data[byte0:byte0 + nbytes], "big")
        shift = nbytes * 8 - (pos & 7) - n
        self.pos = pos + n
        return (acc >> shift) & ((1 << n) - 1)

    def flag(self) -> int:
        pos = self.pos
        if pos >= self.nbits:
            raise EOFError("bitreader overrun")
        self.pos = pos + 1
        return (self.data[pos >> 3] >> (7 - (pos & 7))) & 1

    # -- Exp-Golomb --------------------------------------------------------

    def ue(self) -> int:
        """ue(v): unsigned Exp-Golomb."""
        zeros = 0
        while self.flag() == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid Exp-Golomb code (>32 leading zeros)")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """se(v): signed Exp-Golomb. code_num k -> (-1)^(k+1) * ceil(k/2)."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def te(self, rng: int) -> int:
        """te(v): truncated Exp-Golomb (range 1 is one inverted bit)."""
        if rng == 1:
            return 1 - self.flag()
        return self.ue()

    # -- position / alignment ---------------------------------------------

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP payload before the rbsp_stop_one_bit (the
        last 1-bit of the buffer)."""
        return self.pos < self._stop

    def peek(self, n: int) -> int:
        save = self.pos
        try:
            return self.u(n)
        finally:
            self.pos = save

    def peek_pad(self, n: int) -> int:
        """Peek n bits, zero-padding past the end of the buffer."""
        avail = self.nbits - self.pos
        if avail >= n:
            return self.peek(n)
        if avail <= 0:
            return 0
        return self.peek(avail) << (n - avail)

    def zeros_until_one(self, limit: int = 32) -> int:
        """Count and consume leading zero bits up to and including the 1."""
        n = 0
        while self.flag() == 0:
            n += 1
            if n > limit:
                raise ValueError("runaway zero run in bitstream")
        return n
