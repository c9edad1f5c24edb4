"""The port's recorder (``utils/trace.py``) and its spans and counters in
the flat all-intra encode, on the CPU.

A flat batch under a CPU ``torch.profiler`` records each ``enc.*`` span of
``device_encode`` and the ``fin.coder`` and ``fin.obu`` spans of
``host_finish`` once, inside the call, on the calling thread and without
overlap, and the ``fin.wait`` and ``fin.d2h`` spans of the batch's copy
job once, on the copy thread, between the two; mapped onto the profiler's
clock the spans lie on their ``svt.<name>`` mirrors where the profiler
made one.  Off, nothing is recorded and no profiler
annotation is made.  Tracing changes no byte.  The counters hold the D2H
bytes and the coder's symbols; the tile coder's ctypes declaration has
the C definition's arguments.
"""

import ctypes
import re
import threading
import time
from pathlib import Path

import pytest
import torch

from svtav1_tpu_torch import app
from svtav1_tpu_torch.cuda import inputs
from svtav1_tpu_torch.ec import native
from svtav1_tpu_torch.encoder.intra_encoder import (_D2H, EncoderConfig,
                                                    IntraEncoder)
from svtav1_tpu_torch.utils import log, trace
from svtav1_tpu_torch.utils.y4m import Y4mInfo, Y4mWriter

W, H = 128, 64
ENC = ("enc.stage", "enc.upload", "enc.launch", "enc.deblock")
# device_encode's spans in order: upload and launch once a plane
ENC_CALL = ("enc.stage", "enc.upload", "enc.launch", "enc.upload",
            "enc.launch", "enc.deblock")
# the copy job's spans (on the copy thread), then host_finish's
COPY = ("fin.wait", "fin.d2h")
FIN = ("fin.coder", "fin.obu")


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU ops on one thread: the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encoder(bd=8):
    return IntraEncoder(EncoderConfig(W, H, qindex=100, bit_depth=bd,
                                      part_search=False), device="cpu")


def _frames(bd=8, n=2):
    return (inputs.moving_frames(W, H, n) if bd == 8
            else inputs.synth_frames10(W, H, n))


def _in(recs, t0, t1):
    return [r for r in recs if t0 <= r.start_ns and r.end_ns <= t1]


@pytest.fixture(scope="module")
def profiled():
    """One flat batch of two frames under a CPU profiler: the records,
    the profiler's events, the call bounds and the outputs."""
    torch.set_num_threads(1)
    enc = _encoder()
    frames = _frames()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        dev = enc.device_encode(frames)
        t1 = time.perf_counter_ns()
        before = trace.counters()
        payloads, recons = enc.host_finish(dev)
        after = trace.counters()
        t2 = time.perf_counter_ns()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("svt.")]
    return dict(recs=_in(trace.records(), t0, t2), events=events,
                bounds=(t0, t1, t2), dev=dev, enc=enc, frames=frames,
                payloads=payloads, recons=recons,
                d2h=after.get("d2h.bytes", 0) - before.get("d2h.bytes", 0))


def test_each_stage_span_once_a_call_inside_it(profiled):
    """Each enc.* span once a device_encode call (upload and launch once
    a plane) and fin.coder and fin.obu once a host_finish call, in order,
    inside the call, on the calling thread and without overlap; fin.wait
    and fin.d2h once a batch, in order, on the copy thread and without
    overlap, after the enqueue and before host_finish's wait ends; each
    frame's coder.frame on a coder thread, after the copies and before
    that wait ends."""
    t0, t1, t2 = profiled["bounds"]
    host = [r for r in profiled["recs"] if r.kind == "host"]
    main = threading.get_ident()
    by = {}
    for names, (a, b) in ((ENC_CALL, (t0, t1)), (COPY, (t0, t2)),
                          (FIN, (t1, t2))):
        spans = sorted((r for r in host if r.name in names),
                       key=lambda r: r.start_ns)
        assert [r.name for r in spans] == list(names)
        assert all(a <= r.start_ns <= r.end_ns <= b for r in spans)
        assert all(p.end_ns <= q.start_ns for p, q in zip(spans, spans[1:]))
        assert len({r.thread for r in spans}) == 1
        by.update((r.name, r) for r in spans)
    assert by["enc.stage"].thread == by["fin.coder"].thread == main
    copy = by["fin.wait"].thread
    assert copy != main
    assert by["enc.deblock"].end_ns <= by["fin.wait"].start_ns
    assert by["fin.d2h"].end_ns <= by["fin.coder"].end_ns
    coder = [r for r in host if r.name == "coder.frame"]
    assert len(coder) == 2
    assert all(r.thread not in (main, copy) for r in coder)
    assert all(by["fin.d2h"].end_ns <= r.start_ns and
               r.end_ns <= by["fin.coder"].end_ns for r in coder)


def test_spans_lie_on_their_profiler_mirrors(profiled):
    """Mapped with to_profiler_ns, each stage span agrees with its
    svt.<name> event within 0.5 ms at both ends: every span of the
    calling thread, and the copy job's where the profiler, which records
    the threads it started from, mirrored them."""
    by_name = {}
    for name, s, e in sorted(profiled["events"], key=lambda ev: ev[1]):
        by_name.setdefault(name[4:], []).append((s, e))
    names = ENC + FIN + tuple(n for n in COPY if n in by_name)
    recs = sorted((r for r in profiled["recs"] if r.name in names),
                  key=lambda r: r.start_ns)
    for name in names:
        assert len(by_name[name]) == ENC_CALL.count(name) + \
            (COPY + FIN).count(name)
    seen = {}
    for r in recs:
        k = seen[r.name] = seen.get(r.name, -1) + 1
        s, e = by_name[r.name][k]
        assert abs(trace.to_profiler_ns(r.start_ns) - s) < 500_000, r.name
        assert abs(trace.to_profiler_ns(r.end_ns) - e) < 500_000, r.name


def test_off_records_nothing_and_makes_no_annotation(profiled, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("a profiler annotation while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        forbidden)
    monkeypatch.setattr(trace, "_mirror", forbidden)
    assert not trace.recording()
    enc = profiled["enc"]
    t0 = time.perf_counter_ns()
    dev = enc.device_encode(profiled["frames"])
    payloads, _ = enc.host_finish(dev)
    assert _in(trace.records(), t0, time.perf_counter_ns()) == []
    assert dev["done"] is None
    # the second frame as traced (the first carries the sequence header
    # only in the encoder's first batch)
    assert payloads[1] == profiled["payloads"][1]


def test_off_span_cost(record_property):
    """The off path's cost a span over 1e5 spans, reported (not a gate
    on speed); it records nothing."""
    assert not trace.recording()
    n_before = len(trace.records())
    t = time.perf_counter()
    for _ in range(100_000):
        with trace.span("x"):
            pass
    us = (time.perf_counter() - t) / 100_000 * 1e6
    record_property("off_span_us", us)
    print(f"off span: {us:.3f} us")
    assert len(trace.records()) == n_before


@pytest.mark.parametrize("bd", [8, 10])
def test_tracing_changes_no_byte(bd):
    frames = _frames(bd)
    out = []
    for on in (True, False):
        trace.enable(on)
        try:
            out.append(_encoder(bd).encode_frames(frames))
        finally:
            trace.enable(False)
    (p_on, r_on), (p_off, r_off) = out
    assert p_on == p_off
    for a, b in zip(r_on, r_off):
        for pa, pb in zip(a, b):
            assert pa.dtype == pb.dtype and (pa == pb).all()


def test_d2h_bytes_are_the_tensors_nbytes(profiled):
    dev = profiled["dev"]
    want = sum(dev[k].numel() * dev[k].element_size() for k in _D2H)
    assert profiled["d2h"] == want > 0
    # a sample of the same amount, stamped inside host_finish
    t0, t1, t2 = profiled["bounds"]
    samples = [r for r in profiled["recs"]
               if r.kind == "count" and r.name == "d2h.bytes"]
    assert [r.n for r in samples] == [want]
    assert t1 <= samples[0].start_ns <= t2


def test_coder_symbols_positive_and_repeatable(profiled):
    enc, dev = profiled["enc"], profiled["dev"]
    got = []
    for _ in range(2):
        before = trace.counters().get("coder.symbols", 0)
        enc.host_finish(dev)
        got.append(trace.counters()["coder.symbols"] - before)
    assert got[0] == got[1] > 0
    # more symbols than payload bytes: most code under a bit each
    assert got[0] > sum(len(p) for p in profiled["payloads"])


def test_tile_coder_ctypes_has_the_c_arguments():
    """ec/native.py declares encode_tile_intra with the argument count of
    its definition in native/tile_coder.c (ctypes passes a short call on
    unchecked)."""
    src = Path(native._SRC).read_text()
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    args = re.search(r"^long encode_tile_intra\(([^)]*)\)", src,
                     re.M).group(1)
    count = len([a for a in args.split(",") if a.strip()])
    assert count == 15
    assert len(native._load().encode_tile_intra.argtypes) == count
    assert native._load().encode_tile_intra.argtypes[-2:] == [
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(native._Strip)]


def test_bounded_buffer_drops_the_oldest():
    rec = trace.Recorder(size=3)
    rec.enabled = True
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    rec.count("c", 7)
    assert [r.name for r in rec.records()] == ["s3", "s4", "c"]
    assert rec.dropped == 3
    assert rec.counters() == {"c": 7}


def test_device_span_records_nothing_on_the_cpu():
    rec = trace.Recorder()
    rec.enabled = True
    with rec.device_span("dev.x", torch.device("cpu")) as d:
        pass
    assert d.end is None and rec.records() == []


def test_profiler_clock_offset():
    """to_profiler_ns puts a perf_counter_ns stamp on time.time_ns()'s
    axis (the profiler's) within a millisecond."""
    trace.enable()
    try:
        with trace.span("x"):
            pass
        t, now = time.perf_counter_ns(), time.time_ns()
        assert abs(trace.to_profiler_ns(t) - now) < 1_000_000
    finally:
        trace.enable(False)


def _y4m(path, frames):
    with open(path, "wb") as f:
        wtr = Y4mWriter(f, Y4mInfo(W, H, 30, 1))
        for fr in frames:
            wtr.write_frame(*fr)


def test_cli_debug_prints_the_trace(tmp_path, capsys):
    """At SVT_LOG=debug the CLI logs one line a span and one of the
    counters; at info it logs no more than before."""
    src = tmp_path / "in.y4m"
    _y4m(src, inputs.moving_frames(W, H, 2))
    args = ["-i", str(src), "-b", str(tmp_path / "o.ivf"), "--keyint", "1",
            "--preset", "12", "--device", "cpu"]
    err = {}
    old = log.get_level()
    try:
        for level in (log.DEBUG, log.INFO):
            log.set_level(level)
            capsys.readouterr()
            assert app.main(args) == 0
            err[level] = capsys.readouterr().err.splitlines()
    finally:
        log.set_level(old)
    assert not trace.recording()
    debug = [ln for ln in err[log.DEBUG] if ln.startswith("Svt[debug]")]
    for name in ENC + COPY + FIN + ("coder.frame",):
        assert any(re.search(rf"trace: {re.escape(name)}: \d+ spans, mean "
                             r"[0-9.]+ ms$", ln) for ln in debug), name
    counters = [ln for ln in debug if "trace: counters:" in ln]
    assert len(counters) == 1
    assert "d2h.bytes" in counters[0] and "coder.symbols" in counters[0]
    # the info run's one line, and the debug run's besides its own lines
    masked = [re.sub(r"^(Svt\[\w+\]) +[0-9.]+s ", r"\1 ", ln)
              for ln in err[log.INFO] + [ln for ln in err[log.DEBUG]
                                         if not ln.startswith("Svt[debug]")]]
    assert len(masked) == 2 and "app:" in masked[0]
    assert masked[0] == masked[1]


# ---- the edge strip (m = 12 heights): enc.edge, dev.edge, edge.blocks -- #

EH = 112                        # 128x112: m = 12, a strip of 8 blocks


def test_edge_span_and_blocks_at_an_m12_height():
    """At an m = 12 height, device_encode adds one enc.edge span, after
    the launches and before the deblock, and counts the luma strip blocks
    it coded (2 per 32 columns a frame); the D2H counter includes the
    strip's outputs.  The dev.edge device span records nothing on the
    CPU."""
    enc = IntraEncoder(EncoderConfig(W, EH, qindex=100, part_search=False),
                       device="cpu")
    frames = inputs.moving_frames(W, EH, 2)
    trace.enable(True)
    try:
        t0 = time.perf_counter_ns()
        before = trace.counters()
        dev = enc.device_encode(frames)
        t1 = time.perf_counter_ns()
        enc.host_finish(dev)
        after = trace.counters()
    finally:
        trace.enable(False)
    recs = _in(trace.records(), t0, t1)
    names = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
             if r.kind == "host"]
    assert names == ["enc.stage", "enc.upload", "enc.launch", "enc.upload",
                     "enc.launch", "enc.edge", "enc.deblock"]
    assert not [r for r in recs if r.kind == "device"]
    blocks = after.get("edge.blocks", 0) - before.get("edge.blocks", 0)
    assert blocks == 2 * (2 * W // 32)
    keys = _D2H + ("y_emi", "uv_emi", "y_elev", "uv_elev")
    assert after["d2h.bytes"] - before.get("d2h.bytes", 0) == \
        sum(dev[k].nbytes for k in keys)


def test_no_edge_span_or_blocks_without_a_strip(profiled):
    """A height with m != 12 (the 1080p cells' m = 14, here m = 16) takes
    the path it took before the strip: no enc.edge span, no edge.blocks,
    no strip outputs."""
    assert not [r for r in profiled["recs"] if r.name in ("enc.edge",
                                                          "dev.edge")]
    assert "y_emi" not in profiled["dev"]
    assert not [r for r in profiled["recs"] if r.name == "edge.blocks"]
