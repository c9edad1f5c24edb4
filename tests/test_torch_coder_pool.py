"""The flat path's host stage on the process's coder pool
(``encoder/coder_pool.py``), on the CPU at 128x64.

``device_encode`` queues a batch's copies and coder calls; ``host_finish``
collects them in call order.  Batches queued ahead give the bytes and
recons of ``encode_frames`` batch by batch, with one sequence header; an
error in a frame's coder call surfaces from its batch's ``host_finish``
and the next batch still codes; encoders share the pool's threads; the C
coder's CDF-update flag is per call; ``coder.ahead`` counts the frames
coded before their batch's ``host_finish`` was entered.
"""

import threading
from concurrent.futures import wait
from dataclasses import replace

import numpy as np
import pytest
import torch

from svtav1_tpu_torch.cuda import inputs
from svtav1_tpu_torch.ec import native
from svtav1_tpu_torch.encoder import coder_pool
from svtav1_tpu_torch.encoder.intra_encoder import EncoderConfig, IntraEncoder
from svtav1_tpu_torch.utils import trace
from svtav1_tpu_torch.utils.obu import OBU_SEQUENCE_HEADER, parse_obus

W, H = 128, 64
TIMEOUT = 60


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(bd=8, **kw):
    return EncoderConfig(W, H, qindex=100, bit_depth=bd, part_search=False,
                         **kw)


def _frames(bd=8, n=2):
    return (inputs.moving_frames(W, H, n) if bd == 8
            else inputs.synth_frames10(W, H, n))


def _assert_same(got, want):
    (p1, r1), (p2, r2) = got, want
    assert p1 == p2
    for a, b in zip(r1, r2):
        for pa, pb in zip(a, b):
            assert pa.dtype == pb.dtype and (pa == pb).all()


def _gate():
    """An event that holds the copy thread (and the batches queued behind
    it) until set."""
    gate = threading.Event()
    coder_pool.copier().submit(gate.wait, TIMEOUT)
    return gate


@pytest.mark.parametrize("bd,batch", [(8, 4), (10, 1)],
                         ids=["8bit-b4", "10bit-b1"])
def test_queued_batches_equal_encode_frames(bd, batch):
    """Three batches queued before any host_finish: each batch's payloads
    and recons are encode_frames' of it, batch by batch; only the first
    payload carries the sequence header."""
    frames = _frames(bd, 3 * batch)
    chunks = [frames[k * batch:(k + 1) * batch] for k in range(3)]
    ref = IntraEncoder(_cfg(bd), device="cpu")
    want = [ref.encode_frames(c) for c in chunks]
    enc = IntraEncoder(_cfg(bd), device="cpu")
    devs = [enc.device_encode(c) for c in chunks]
    got = [enc.host_finish(d) for d in devs]
    for g, w in zip(got, want):
        _assert_same(g, w)
    headers = [any(t == OBU_SEQUENCE_HEADER for t, *_ in parse_obus(p))
               for ps, _ in got for p in ps]
    assert headers == [True] + [False] * (3 * batch - 1)


def test_coder_error_surfaces_from_its_batch(monkeypatch):
    """A coder call that raises for one frame of batch A: A's host_finish
    raises it; batch B, queued behind it, still codes (as a fresh
    encoder's first batch: A wrote no OBU)."""
    enc = IntraEncoder(_cfg(), device="cpu")
    frames = _frames(n=3)
    inner, bad = native.encode_tile_intra, {}

    def planted(*a, **k):
        if np.array_equal(a[4], bad["y_lev"]):
            raise RuntimeError("planted coder fault")
        return inner(*a, **k)

    monkeypatch.setattr(native, "encode_tile_intra", planted)
    gate = _gate()
    try:
        dev_a = enc.device_encode(frames[:2])
        dev_b = enc.device_encode(frames[2:])
        bad["y_lev"] = dev_a["y_lev"][1].numpy()
    finally:
        gate.set()
    with pytest.raises(RuntimeError, match="planted coder fault"):
        enc.host_finish(dev_a)
    got = enc.host_finish(dev_b)
    monkeypatch.setattr(native, "encode_tile_intra", inner)
    _assert_same(got, IntraEncoder(_cfg(), device="cpu").host_finish(dev_b))


def test_encoders_share_the_pool_threads():
    """Twenty encoders as _capped_recode makes them, each coding a batch
    of two frames, leave at most the pool's width plus the copy thread
    above the threads there were."""
    before = threading.active_count()
    enc = IntraEncoder(_cfg(), device="cpu")
    dev = enc.device_encode(_frames())
    want = enc.host_finish(dev)
    subs = [IntraEncoder(replace(enc.cfg, qindex=enc.cfg.qindex),
                         device="cpu") for _ in range(20)]
    for sub in subs:
        _assert_same(sub.host_finish(dev), want)
    assert threading.active_count() <= before + coder_pool.width() + 1
    assert coder_pool.width() >= 1


def test_cdf_update_is_per_call(monkeypatch):
    """Two encoders, CDF update on and off, coding at once (each coder
    call waits for the other's to start): each gives the bytes it gives
    alone."""
    encs = [IntraEncoder(_cfg(cdf_update=u), device="cpu")
            for u in (True, False)]
    frames = _frames(n=1)
    alone = [e.encode_frames(frames) for e in encs]
    assert alone[0][0] != alone[1][0]
    inner = native.encode_tile_intra
    together = threading.Barrier(2)

    def at_once(*a, **k):
        if coder_pool.width() > 1:
            together.wait(TIMEOUT)
        return inner(*a, **k)

    monkeypatch.setattr(native, "encode_tile_intra", at_once)
    for e in encs:
        e._first = True
    gate = _gate()
    try:
        devs = [e.device_encode(frames) for e in encs]
    finally:
        gate.set()
    for e, d, a in zip(encs, devs, alone):
        _assert_same(e.host_finish(d), a)


def test_coder_ahead_counts_frames_coded_before_host_finish():
    """Frames coded before their batch's host_finish count one each; a
    batch whose copies are held until host_finish is entered counts
    none."""
    enc = IntraEncoder(_cfg(), device="cpu")
    frames = _frames()

    def ahead():
        return trace.counters().get("coder.ahead", 0)

    c0 = ahead()
    dev = enc.device_encode(frames)
    _, coded = dev["job"].result(TIMEOUT)
    assert not wait(coded, TIMEOUT).not_done
    enc.host_finish(dev)
    assert ahead() - c0 == 2

    c0 = ahead()
    gate = _gate()
    try:
        dev = enc.device_encode(frames)
        out = []
        finish = threading.Thread(
            target=lambda: out.append(enc.host_finish(dev)))
        finish.start()
        assert dev["entered"].wait(TIMEOUT)
    finally:
        gate.set()
    finish.join(TIMEOUT)
    assert not finish.is_alive() and len(out) == 1
    assert ahead() == c0
