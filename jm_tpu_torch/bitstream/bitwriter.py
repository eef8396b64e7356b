"""MSB-first bit writer producing RBSP payloads.

Encoder-side counterpart of BitReader: u(n), ue(v), se(v), byte alignment,
rbsp_trailing_bits. Capability parity with lencod/src/vlc.c (write_ue_v,
write_se_v, write_u_v, writeUVLC2buffer) — new implementation.

The hot encoder path does NOT use this class per-symbol: batched entropy
kernels compute (value, length) pairs on device and the host packs them
(see jm_tpu/encoder). This writer is for headers/parameter sets and as a
correctness reference for the packers.
"""

from __future__ import annotations


class BitWriter:
    __slots__ = ("buf", "acc", "nacc")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.acc = 0  # bit accumulator (MSB-first semantics)
        self.nacc = 0  # number of bits in acc

    def u(self, value: int, n: int) -> None:
        if n == 0:
            return
        if value < 0 or value >> n:
            raise ValueError(f"value {value} does not fit in {n} bits")
        self.acc = (self.acc << n) | value
        self.nacc += n
        while self.nacc >= 8:
            self.nacc -= 8
            self.buf.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def flag(self, value: int) -> None:
        self.u(1 if value else 0, 1)

    def ue(self, value: int) -> None:
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        code = value + 1
        n = code.bit_length()
        self.u(0, n - 1)
        self.u(code, n)

    def se(self, value: int) -> None:
        # mapping: 0,1,-1,2,-2,... -> 0,1,2,3,4,...
        k = 2 * value - 1 if value > 0 else -2 * value
        self.ue(k)

    def te(self, value: int, rng: int) -> None:
        """te(v) with the range rng: one inverted bit when it is 1, else
        ue(v)."""
        if rng == 1:
            self.u(1 - value, 1)
        else:
            self.ue(value)

    def append_bitstream(self, data: bytes, nbits: int) -> None:
        """Append `nbits` MSB-first bits taken from `data` (a packed byte
        string) in one vectorized operation — the host-side merge point
        for device-packed entropy payloads (ops/cavlc_jax)."""
        import numpy as np
        if nbits == 0:
            return
        need = (nbits + 7) // 8
        a = np.frombuffer(data, np.uint8)[:need].astype(np.uint16)
        p = self.nacc
        if p == 0:
            full, rem = divmod(nbits, 8)
            self.buf += data[:full]
            if rem:
                self.acc = int(a[full]) >> (8 - rem)
                self.nacc = rem
            return
        total = p + nbits
        nfull, rem = divmod(total, 8)
        ext = np.concatenate([
            np.array([self.acc], np.uint16), a,
            np.zeros(2, np.uint16)])
        out = (((ext[:-1] << (8 - p)) | (ext[1:] >> p)) & 0xFF) \
            .astype(np.uint8)
        self.buf += out[:nfull].tobytes()
        if rem:
            self.acc = int(out[nfull]) >> (8 - rem)
        else:
            self.acc = 0
        self.nacc = rem
        # mask stray bits beyond nbits that leaked from the last byte
        self.acc &= (1 << rem) - 1 if rem else 0

    @property
    def bitpos(self) -> int:
        return len(self.buf) * 8 + self.nacc

    def byte_aligned(self) -> bool:
        return self.nacc == 0

    def rbsp_trailing_bits(self) -> None:
        self.u(1, 1)
        self.align_zero()

    def align_zero(self) -> None:
        """Zero bits up to the next byte boundary (after a CABAC slice's
        terminating bin, whose flush wrote the rbsp_stop_one_bit)."""
        if self.nacc:
            self.u(0, 8 - self.nacc)

    def get_bytes(self) -> bytes:
        if self.nacc:
            raise ValueError("bitstream not byte aligned; call rbsp_trailing_bits()")
        return bytes(self.buf)
