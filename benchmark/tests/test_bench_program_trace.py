"""The readers of the program's own spans and counters
(``svtav1_tpu_torch/utils/trace.py``): nothing without a trace or without
the recorder (a program that has none, as before it was added), the
hand-computed value on a synthetic run with records and device events
planted on known clocks, and a traced tiny run on the CPU whose parts add
up to the harness's spans around the same calls."""

import json
import sys

import pytest
import torch

from benchmark import run
from benchmark.pipelines.all_intra import Window
from benchmark.tests.tiny import REPO, TINY, tiny_root

NEW = ("stage_ms", "upload_ms", "launch_ms", "deblock_enqueue_ms",
       "deblock_device_ms", "d2h_wait_ms", "d2h_copy_ms", "coder_wall_ms",
       "obu_ms", "d2h_bytes_per_frame", "coder_symbols_per_s",
       "idle_coder_pct", "setup_build_s")
S = 1_000_000_000                   # ns a second
OFF = 7 * S                         # the profiler's clock minus the host's


def _reader(name):
    return run._reader(REPO, name)


def _run(trace=True, events=()):
    w = Window(t0=10.0, t_end=11.0, frames=4)
    tr = run.Trace(list(events), 1.0, 0.0, {}) if trace else None
    return run.Run(w, 1.0, 40.0, tr, 8)


def _planted(monkeypatch, recs):
    from svtav1_tpu_torch.utils import trace
    from svtav1_tpu_torch.utils.trace import Record
    monkeypatch.setattr(trace, "records",
                        lambda: [Record(*r) for r in recs])
    monkeypatch.setattr(trace, "to_profiler_ns", lambda t: t + OFF)


def test_every_new_metric_has_an_entry():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert entries[name]["moves"] == ("setup_s" if name == "setup_build_s"
                                          else "encode_fps")


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_a_trace(name, monkeypatch):
    _planted(monkeypatch, [("host", "enc.stage", 10 * S, 10 * S + 5, 0)])
    assert _reader(name).read(_run(trace=False)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_from_a_program_without_the_recorder(name, monkeypatch):
    import svtav1_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "svtav1_tpu_torch.utils.trace", None)
    assert _reader(name).read(_run(events=[("k", 10 * S, 11 * S)])) is None


def _at(t):
    return int(t * S)


RECS = [
    # outside the window [10 s, 11 s]: left out (but setup.build counts)
    ("host", "enc.stage", _at(9.0), _at(9.5), 0),
    ("host", "enc.stage", _at(11.2), _at(11.3), 0),
    ("host", "setup.build", _at(1.0), _at(1.5), 0),
    ("host", "setup.build", _at(2.0), _at(2.25), 0),
    # inside
    ("host", "enc.stage", _at(10.1), _at(10.102), 0),
    ("host", "enc.stage", _at(10.5), _at(10.504), 0),
    # upload and launch once a plane: 5 ms and 12 ms over two calls
    ("host", "enc.upload", _at(10.11), _at(10.111), 0),
    ("host", "enc.launch", _at(10.112), _at(10.117), 0),
    ("host", "enc.upload", _at(10.118), _at(10.119), 0),
    ("host", "enc.launch", _at(10.12), _at(10.123), 0),
    ("host", "enc.upload", _at(10.505), _at(10.508), 0),
    ("host", "enc.launch", _at(10.51), _at(10.514), 0),
    ("host", "enc.deblock", _at(10.13), _at(10.132), 0),
    ("device", "dev.deblock", _at(10.13), _at(10.131), 1),
    ("device", "dev.deblock", _at(10.53), _at(10.533), 2),
    ("host", "fin.wait", _at(10.14), _at(10.146), 0),
    ("host", "fin.d2h", _at(10.15), _at(10.17), 0),
    ("count", "d2h.bytes", _at(10.16), _at(10.16), 1000),
    ("count", "d2h.bytes", _at(10.56), _at(10.56), 1000),
    ("host", "fin.coder", _at(10.3), _at(10.5), 0),
    ("host", "fin.coder", _at(10.65), _at(10.8), 0),
    ("host", "fin.coder", _at(11.2), _at(11.4), 0),
    ("host", "coder.frame", _at(10.3), _at(10.31), 0),
    ("host", "coder.frame", _at(10.32), _at(10.35), 0),
    ("count", "coder.symbols", _at(10.31), _at(10.31), 3000),
    ("count", "coder.symbols", _at(10.35), _at(10.35), 5000),
    ("count", "coder.symbols", _at(11.35), _at(11.35), 9999),
    ("host", "fin.obu", _at(10.81), _at(10.8107), 0),
]
# busy on the profiler's clock [10.0, 10.2] and [10.6, 10.7] s: idle
# [10.2, 10.6] and [10.7, 11.0], 0.7 s; fin.coder covers 0.2 s of the
# first and 0.1 s of the second (its 0.05 s over busy time is no idle)
MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"
# the dev.deblock spans' markers lie inside the busy time, each a
# 10 us kernel: the spans start there and are busy all through
EVENTS = [("k", _at(10.0) + OFF, _at(10.2) + OFF),
          (MARK, _at(10.1305) + OFF, _at(10.13051) + OFF),
          ("k", _at(10.6) + OFF, _at(10.7) + OFF),
          (MARK, _at(10.61) + OFF, _at(10.61001) + OFF),
          ("k", _at(12.0) + OFF, _at(13.0) + OFF)]
WANT = {"stage_ms": 3.0, "upload_ms": 2.5, "launch_ms": 6.0,
        "deblock_enqueue_ms": 2.0, "deblock_device_ms": 2.0,
        "d2h_wait_ms": 6.0, "d2h_copy_ms": 20.0, "coder_wall_ms": 175.0,
        "obu_ms": 0.7, "d2h_bytes_per_frame": 500.0,
        "coder_symbols_per_s": 8000 / 0.04,
        "idle_coder_pct": 100.0 * 0.3 / 0.7, "setup_build_s": 0.75}


@pytest.mark.parametrize("name", NEW)
def test_hand_computed_values(name, monkeypatch):
    _planted(monkeypatch, RECS)
    got = _reader(name).read(_run(events=EVENTS))
    assert got == pytest.approx(WANT[name], rel=1e-9)


def test_deblock_device_counts_only_the_kernels_inside(monkeypatch):
    """A dev.deblock span starts on the device timeline where its marker
    (the second, as its n says) ends, whatever the host's clock says:
    of the span's 10 ms on the stream only the device work inside counts
    (1.7 ms), not the wait for the host enqueue nor the kernels before
    and after it.  A span made without a profiler (n 0) is left out; a
    span whose marker is not in the trace reads nothing."""
    read = _reader("deblock_device_ms").read
    _planted(monkeypatch, [
        ("device", "dev.deblock", _at(10.1), _at(10.11), 2),
        ("device", "dev.deblock", _at(10.5), _at(10.51), 0)])
    m = _at(10.095) + OFF           # 5 ms before the enqueue by the host
    lo, hi = m + 2000, m + 2000 + _at(0.01)
    events = [(MARK, _at(10.05) + OFF, _at(10.05) + OFF + 2000),
              ("wf_plane_kernel", _at(10.06) + OFF, m),
              (MARK, m, lo),
              ("elementwise", lo + 100_000, lo + 1_100_000),
              ("elementwise", lo + 5_000_000, lo + 5_500_000),
              ("elementwise", hi - 200_000, hi + 1_000_000),
              ("Memcpy DtoH", hi + 2_000_000, hi + 3_000_000)]
    assert read(_run(events=events)) == pytest.approx(1.7, rel=1e-9)
    assert read(_run(events=events[:2])) is None


def test_idle_coder_counts_only_idle_time(monkeypatch):
    """A fin.coder span over busy time alone adds nothing; one over the
    whole window covers all of the idle time."""
    read = _reader("idle_coder_pct").read
    _planted(monkeypatch, [("host", "fin.coder", _at(10.0), _at(10.2), 0)])
    assert read(_run(events=EVENTS)) == 0.0
    _planted(monkeypatch, [("host", "fin.coder", _at(10.0), _at(11.0), 0)])
    assert read(_run(events=EVENTS)) == pytest.approx(100.0)


def test_traced_tiny_run_parts_add_up(tmp_path):
    """A traced run of the tiny cell on the CPU: the host-side metrics
    are there (the device ones are not, with no device events), the
    enc.* parts make up device_encode_ms and the fin.* parts
    host_finish_ms, and d2h_bytes_per_frame is the outputs' bytes."""
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    result, _ = run.run_cell(TINY, 2**31 + 77, 3.0, True, device="cpu",
                             root=root)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"] is True
    assert set(NEW) - set(m) == {"deblock_device_ms", "idle_coder_pct"}
    enc = m["stage_ms"] + m["upload_ms"] + m["launch_ms"] + \
        m["deblock_enqueue_ms"]
    fin = m["d2h_wait_ms"] + m["d2h_copy_ms"] + m["coder_wall_ms"] + \
        m["obu_ms"]
    assert 0.9 <= enc / m["device_encode_ms"] <= 1.0
    assert 0.9 <= fin / m["host_finish_ms"] <= 1.0
    # 256x128 padded: int32 levels, uint8 recons, int32 maps of 32x32
    # luma and 16x16 chroma blocks (U and V)
    h, w = 128, 256
    want = 4 * (h * w + 2 * (h // 2) * (w // 2)) + \
        (h * w + 2 * (h // 2) * (w // 2)) + \
        4 * ((h // 32) * (w // 32) + 2 * (h // 32) * (w // 32))
    assert m["d2h_bytes_per_frame"] == want
    assert m["coder_symbols_per_s"] > 0 and m["setup_build_s"] > 0
