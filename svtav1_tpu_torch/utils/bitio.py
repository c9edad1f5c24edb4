"""Bit-level writer and LEB128 for AV1 headers and containers.

Copy of ``svtav1_tpu/utils/bitio.py``, cut to what the port writes.  AV1
headers are written MSB-first ("f(n)" in the AV1 spec §4.10.2); sizes use
LEB128 (§4.10.5).
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
