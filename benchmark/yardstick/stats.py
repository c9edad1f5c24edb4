"""The benchmark's arithmetic on spans, events and pictures."""

from __future__ import annotations

import statistics

import numpy as np


def busy_union(spans) -> float:
    """Length of the union of [start, end) intervals (the device's busy
    time from its trace events)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_gaps(spans, t0: float, t1: float) -> list:
    """The (start, end) gaps of [t0, t1) that no interval covers."""
    gaps, end = [], t0
    for s, e in sorted(spans):
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
    if end < t1:
        gaps.append((end, t1))
    return [(s, e) for s, e in gaps if e > s]


def percentile(values, pct: int) -> float:
    """The pct-th percentile (pct a multiple of 10) by Python's
    statistics.quantiles, exclusive method."""
    return statistics.quantiles(values, n=10)[pct // 10 - 1]


def psnr(src: np.ndarray, rec: np.ndarray, bd: int) -> float:
    """Luma PSNR in dB at peak 2^bd - 1 (inf for identical planes)."""
    mse = np.mean((src.astype(np.float64) - rec.astype(np.float64)) ** 2)
    peak = float((1 << bd) - 1)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)
