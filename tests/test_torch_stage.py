"""The flat path's host staging slots (``IntraEncoder._stage``), on the
CPU.

A batch's source planes are written into one of two slots of its size,
used in turn: each slot then holds what the stack, bottom pad and cast
gave before, element for element, at 8 and 10 bits, at the heights of
the 1080p (m = 14) and 4K (m = 12) cells, whether the slot is new or
reused.  A run of batches of 4, 4, 1 and 4 queued as the CLI queues them
(the next batch before the last one's host_finish) gives the payloads
and recons of a fresh encoder a batch, and the stage.reused counter
reads 0, 0, 0, 1.  A reused slot waits for its last H2D before it is
written, and on the CPU the device stage reads a copy, never the slot.
"""

import numpy as np
import pytest
import torch

from svtav1_tpu_torch.cuda import inputs
from svtav1_tpu_torch.encoder.geometry import height_m, pad_plane_bottom
from svtav1_tpu_torch.encoder.intra_encoder import EncoderConfig, IntraEncoder
from svtav1_tpu_torch.utils import trace

W = 128
# the 1080p cells' bottom SB row (m = 14) and the 4K cell's (m = 12)
HEIGHTS = (56, 48)
RUN = (4, 4, 1, 4)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encoder(bd, h):
    return IntraEncoder(EncoderConfig(W, h, qindex=100, bit_depth=bd,
                                      part_search=False), device="cpu")


def _frames(bd, h, n, seed=0):
    return (inputs.moving_frames(W, h, n, seed=seed) if bd == 8
            else inputs.synth_frames10(W, h, n, seed=seed))


def _old_staging(frames, ph, bd):
    """The luma and U+V tensors device_encode uploaded before the slots:
    np.stack, pad_plane_bottom, the cast to the pixel dtype."""
    dt = np.uint8 if bd == 8 else np.int16
    y = pad_plane_bottom(np.stack([f[0] for f in frames]), ph)
    uv = pad_plane_bottom(np.concatenate(
        [np.stack([f[1] for f in frames]),
         np.stack([f[2] for f in frames])]), ph // 2)
    return (torch.from_numpy(np.ascontiguousarray(a, dt)) for a in (y, uv))


@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("h", HEIGHTS)
@pytest.mark.parametrize("bd", (8, 10))
def test_slot_holds_the_old_staging(bd, h, n):
    """Three batches of other frames: the first two each fill a new slot,
    the third the first slot again, and every time the slot's luma and
    U+V equal the old staging element for element (dtype and pad rows
    included); on the CPU the device stage gets a copy of each."""
    enc = _encoder(bd, h)
    assert height_m(h) == (14 if h == 56 else 12) and enc.ph == 64
    slots = []
    for seed in range(3):
        frames = _frames(bd, h, n, seed)
        slot = enc._stage(frames)
        slots.append(slot)
        want_y, want_uv = _old_staging(frames, enc.ph, bd)
        assert slot.y.dtype == want_y.dtype and slot.uv.dtype == want_uv.dtype
        assert torch.equal(slot.y, want_y) and torch.equal(slot.uv, want_uv)
        for t in (slot.y, slot.uv):
            out = enc._h2d(t)
            assert torch.equal(out, t)
            assert out.untyped_storage().data_ptr() != \
                t.untyped_storage().data_ptr()
    assert slots[2] is slots[0] and slots[1] is not slots[0]
    assert enc._stage_slots[n] == [slots[1], slots[0]]


@pytest.fixture(scope="module", params=[(bd, h) for bd in (8, 10)
                                        for h in HEIGHTS],
                ids=lambda p: f"{p[0]}bit-h{p[1]}")
def overlapped(request):
    """Batches of 4, 4, 1 and 4 frames through one encoder, each queued
    before the previous one's host_finish (the CLI's order), with the
    stage.reused samples of each device_encode call; and each batch
    through a fresh encoder's encode_frames."""
    torch.set_num_threads(1)
    bd, h = request.param
    clip = _frames(bd, h, sum(RUN))
    cut = np.cumsum((0,) + RUN)
    batches = [clip[a:b] for a, b in zip(cut, cut[1:])]
    enc = _encoder(bd, h)
    got, reused = [], []
    trace.enable(True)
    try:
        pending = None
        for batch in batches:
            seen = len(trace.records())
            dev = enc.device_encode(batch)
            reused.append([r.n for r in trace.records()[seen:]
                           if r.kind == "count" and r.name == "stage.reused"])
            if pending is not None:
                got.append(enc.host_finish(pending))
            pending = dev
        got.append(enc.host_finish(pending))
    finally:
        trace.enable(False)
    want = []
    for k, batch in enumerate(batches):
        ref = _encoder(bd, h)
        ref._first = k == 0
        want.append(ref.encode_frames(batch))
    return dict(got=got, want=want, reused=reused)


def test_overlapped_run_equals_fresh_encoders(overlapped):
    for (gp, gr), (wp, wr) in zip(overlapped["got"], overlapped["want"]):
        assert gp == wp
        assert len(gr) == len(wr)
        for a, b in zip(gr, wr):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_stage_reused_counts_the_slots_that_existed(overlapped):
    """One sample a call: 1 only where the batch's size already had both
    its slots (the fourth batch, back at size 4)."""
    assert overlapped["reused"] == [[0], [0], [0], [1]]


class _PlantedEvent:
    """An H2D event not yet done: its synchronize records the call and
    what the slot held at that moment."""

    def __init__(self, slot, log):
        self.slot, self.log = slot, log

    def synchronize(self):
        self.log.append(("synchronize", self.slot.y_np.copy(),
                         self.slot.uv_np.copy()))


@pytest.mark.parametrize("bd", (8, 10))
def test_reused_slot_waits_for_its_h2d_before_it_is_written(bd):
    """The third batch of a size takes the first batch's slot: it calls
    that slot's event's synchronize once, while the slot still holds the
    first batch, and only then writes the third batch into it.  New
    slots have no event to wait on."""
    h, n = 48, 2
    enc = _encoder(bd, h)
    first = _frames(bd, h, n, seed=0)
    slot = enc._stage(first)
    assert slot.event is None
    enc._stage(_frames(bd, h, n, seed=1))
    log = []
    slot.event = _PlantedEvent(slot, log)
    third = _frames(bd, h, n, seed=2)
    enc.host_finish(enc.device_encode(third))
    assert [e[0] for e in log] == ["synchronize"]
    for held, want in zip(log[0][1:], _old_staging(first, enc.ph, bd)):
        assert np.array_equal(held, want.numpy().view(held.dtype))
    for t, want in zip((slot.y, slot.uv), _old_staging(third, enc.ph, bd)):
        assert torch.equal(t, want)
