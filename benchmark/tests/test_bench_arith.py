"""The metric arithmetic on synthetic spans, events and pictures."""

import math
from types import SimpleNamespace as NS

import numpy as np
import pytest

from benchmark.metrics import (batch_ms_p90, bytes_per_frame,
                               device_encode_ms, device_idle_pct,
                               encode_fps, tile_coder_ms,
                               wavefront_roofline_pct)
from benchmark.yardstick import stats, workcount


def test_busy_union():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert stats.busy_union(spans) == 25
    assert stats.busy_union([]) == 0


def test_idle_gaps():
    assert stats.idle_gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == \
        [(0, 2), (6, 8), (9, 10)]
    assert stats.idle_gaps([], 0, 5) == [(0, 5)]


def test_percentile():
    assert stats.percentile(list(range(1, 100)), 90) == 90.0


def test_psnr():
    a = np.full((8, 8), 100, np.uint8)
    b = a.copy()
    b[0, 0] = 110                  # mse 100 / 64
    assert stats.psnr(a, b, 8) == pytest.approx(
        10 * math.log10(255 ** 2 * 64 / 100))
    assert stats.psnr(a, a, 10) == float("inf")


def _run(**kw):
    w = NS(t0=10.0, t_end=20.0, frames=200, payload_bytes=200 * 1000,
           batch_done=[10.0 + 0.05 * k for k in range(1, 201)],
           spans={"device_encode": [(0.0, 0.002), (1.0, 1.004)]},
           coder_s=[0.01, 0.03], plane_calls=[(32, 4, 1088, 1920, False)])
    trace = NS(device_events=[("void wf_plane_kernel<32, unsigned char>", 0,
                               4_000_000),
                              ("memcpy", 5_000_000, 6_000_000)],
               busy_s=0.5, window_s=2.0)
    run = NS(window=w, trace=trace, bit_depth=8, setup_s=1.0, psnr_y=35.0)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_end_to_end_readers():
    run = _run()
    assert encode_fps.read(run) == 20.0
    assert bytes_per_frame.read(run) == 1000.0


def test_per_layer_readers():
    run = _run()
    assert batch_ms_p90.read(run) == pytest.approx(50.0)
    assert device_encode_ms.read(run) == pytest.approx(3.0)
    assert tile_coder_ms.read(run) == pytest.approx(20.0)
    assert device_idle_pct.read(run) == pytest.approx(75.0)
    least = workcount.least_seconds(32, 4, 1088, 1920, False, 8)
    assert wavefront_roofline_pct.read(run) == pytest.approx(
        100 * least / 4e-3)


def test_readers_say_nothing_without_a_trace():
    run = _run(trace=None)
    for mod in (device_encode_ms, tile_coder_ms, device_idle_pct,
                wavefront_roofline_pct):
        assert mod.read(run) is None
    run = _run()
    run.trace.device_events = [("memcpy", 0, 10)]
    assert wavefront_roofline_pct.read(run) is None


def test_p90_needs_samples():
    run = _run()
    run.window.batch_done = run.window.batch_done[:10]
    assert batch_ms_p90.read(run) is None
