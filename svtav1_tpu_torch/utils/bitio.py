"""Bit-level writer and reader and LEB128 for AV1 headers and containers.

Copy of ``svtav1_tpu/utils/bitio.py``, cut to what the port writes and
the decoder reads.  AV1 headers are written MSB-first ("f(n)" in the AV1
spec §4.10.2); sizes use LEB128 (§4.10.5).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer (AV1 f(n) descriptor)."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._bitpos = 0  # bits already used in the last byte (0..7)

    def f(self, value: int, n: int) -> None:
        """Write `value` as n bits, MSB first."""
        if n < 0 or (n < 64 and value >> n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        for i in range(n - 1, -1, -1):
            bit = (value >> i) & 1
            if self._bitpos == 0:
                self._bytes.append(0)
            self._bytes[-1] |= bit << (7 - self._bitpos)
            self._bitpos = (self._bitpos + 1) & 7

    def bit(self, value: int) -> None:
        self.f(value, 1)

    def byte_align(self) -> None:
        if self._bitpos:
            self.f(0, 8 - self._bitpos)

    def data(self) -> bytes:
        """Byte-aligned contents (zero-padded in the final partial byte)."""
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader (the decoder's header parse)."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def bit(self) -> int:
        return self.f(1)

    def uvlc(self) -> int:
        leading_zeros = 0
        while self.f(1) == 0:
            leading_zeros += 1
            if leading_zeros >= 32:
                return (1 << 32) - 1
        if leading_zeros == 0:
            return 0
        return (1 << leading_zeros) - 1 + self.f(leading_zeros)

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bits_read(self) -> int:
        return self._pos


def leb128_encode(value: int) -> bytes:
    """LEB128 (spec §4.10.5)."""
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def leb128_decode(data: bytes, pos: int = 0):
    """Returns (value, new_pos)."""
    value = 0
    for i in range(8):
        byte = data[pos + i]
        value |= (byte & 0x7F) << (7 * i)
        if not (byte & 0x80):
            return value, pos + i + 1
    raise ValueError("leb128 too long")
