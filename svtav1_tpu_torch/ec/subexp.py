"""Finite subexponential coding with a reference (spec §5.9.26-28).

Copy of the writing half of ``svtav1_tpu/ec/subexp.py``: the raw-bit
variant that frame headers use for global-motion parameters.
"""

from __future__ import annotations


def _recenter_nonneg(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v >= r:
        return (v - r) << 1
    return ((r - v) << 1) - 1


def _recenter_finite(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _recenter_nonneg(r, v)
    return _recenter_nonneg(n - 1 - r, n - 1 - v)


def _literal(w, v: int, n: int) -> None:
    if n:
        w.f(v, n)


def _write_quniform(w, n: int, v: int) -> None:
    """ns(n) — quasi-uniform (spec §4.10.7)."""
    if n <= 1:
        return
    l = (n - 1).bit_length()
    m = (1 << l) - n
    if v < m:
        _literal(w, v, l - 1)
    else:
        _literal(w, m + ((v - m) >> 1), l - 1)
        _literal(w, (v - m) & 1, 1)


def _write_subexpfin(w, n: int, k: int, v: int) -> None:
    i, mk = 0, 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            _write_quniform(w, n - mk, v - mk)
            return
        if v >= mk + a:
            _literal(w, 1, 1)
            i += 1
            mk += a
        else:
            _literal(w, 0, 1)
            _literal(w, v - mk, b)
            return


def write_signed_subexp_bits(w, low: int, high: int, ref: int,
                             v: int) -> None:
    """BitWriter raw-bit signed subexp with reference, k=3: v and ref in
    [low, high)."""
    n = high - low
    _write_subexpfin(w, n, 3, _recenter_finite(n, ref - low, v - low))
