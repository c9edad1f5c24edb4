"""Finite subexponential coding with a reference (spec §4.10.7-8, §5.9.26).

Copy of ``svtav1_tpu/ec/subexp.py``.  The writers take any `enc` with
``encode_literal(value, bits)`` and the readers any `dec` with
``decode_literal(bits)``: the range coder (loop restoration coefficients,
raw equiprobable bool-coder bits) or, through ``_BitWriterShim`` /
``_BitReaderShim``, a frame-header BitWriter / BitReader (global-motion
parameters).
"""

from __future__ import annotations


def _recenter_nonneg(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _recenter_finite(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _recenter_nonneg(r, v)
    return _recenter_nonneg(n - 1 - r, n - 1 - v)


def write_quniform(enc, n: int, v: int) -> None:
    """ns(n) — quasi-uniform (spec §4.10.7)."""
    if n <= 1:
        return
    l = (n - 1).bit_length()
    m = (1 << l) - n
    if v < m:
        enc.encode_literal(v, l - 1)
    else:
        enc.encode_literal(m + ((v - m) >> 1), l - 1)
        enc.encode_literal((v - m) & 1, 1)


def read_quniform(dec, n: int) -> int:
    if n <= 1:
        return 0
    l = (n - 1).bit_length()
    m = (1 << l) - n
    v = dec.decode_literal(l - 1)
    if v < m:
        return v
    return (v << 1) - m + dec.decode_literal(1)


def write_subexpfin(enc, n: int, k: int, v: int) -> None:
    i, mk = 0, 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            write_quniform(enc, n - mk, v - mk)
            return
        if v >= mk + a:
            enc.encode_literal(1, 1)
            i += 1
            mk += a
        else:
            enc.encode_literal(0, 1)
            enc.encode_literal(v - mk, b)
            return


def read_subexpfin(dec, n: int, k: int) -> int:
    i, mk = 0, 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return read_quniform(dec, n - mk) + mk
        if dec.decode_literal(1):
            i += 1
            mk += a
        else:
            return dec.decode_literal(b) + mk


def write_refsubexpfin(enc, n: int, k: int, ref: int, v: int) -> None:
    write_subexpfin(enc, n, k, _recenter_finite(n, ref, v))


def read_refsubexpfin(dec, n: int, k: int, ref: int) -> int:
    v = read_subexpfin(dec, n, k)
    if (ref << 1) <= n:
        return _inverse_recenter(ref, v)
    return n - 1 - _inverse_recenter(n - 1 - ref, v)


def write_signed_refsubexpfin(enc, low: int, high: int, k: int, ref: int,
                              v: int) -> None:
    """Signed value in [low, high); ref/v are actual values."""
    write_refsubexpfin(enc, high - low, k, ref - low, v - low)


def read_signed_refsubexpfin(dec, low: int, high: int, k: int,
                             ref: int) -> int:
    return read_refsubexpfin(dec, high - low, k, ref - low) + low


class _BitWriterShim:
    def __init__(self, w):
        self.w = w

    def encode_literal(self, v: int, n: int) -> None:
        if n:
            self.w.f(v, n)


class _BitReaderShim:
    def __init__(self, r):
        self.r = r

    def decode_literal(self, n: int) -> int:
        return self.r.f(n) if n else 0


def write_signed_subexp_bits(w, low: int, high: int, ref: int,
                             v: int) -> None:
    """BitWriter raw-bit signed subexp with reference, k=3: v and ref in
    [low, high)."""
    write_signed_refsubexpfin(_BitWriterShim(w), low, high, 3, ref, v)


def read_signed_subexp_bits(r, low: int, high: int, ref: int) -> int:
    return read_signed_refsubexpfin(_BitReaderShim(r), low, high, 3, ref)
