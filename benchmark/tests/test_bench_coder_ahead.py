"""The coder_ahead_pct reader on planted records: nothing without a trace,
without the recorder, or from a program that has no coder.ahead counter
(as before the coder pool was fed by device_encode); else the window's
coder.ahead total over its coder.frame spans, in %."""

import json
import sys

import pytest

from benchmark import run
from benchmark.tests.test_bench_program_trace import _at, _planted, _run
from benchmark.tests.tiny import REPO

FRAMES = [("host", "coder.frame", _at(t), _at(t + 0.01), 0)
          for t in (10.1, 10.2, 10.3, 10.4, 10.5)]
AHEAD = [("count", "coder.ahead", _at(t), _at(t), n)
         for t, n in ((10.1, 1), (10.2, 1), (10.3, 0), (10.4, 1),
                      (10.5, 1))]
# outside the window [10 s, 11 s]: left out
OUTSIDE = [("host", "coder.frame", _at(11.5), _at(11.51), 0),
           ("count", "coder.ahead", _at(9.5), _at(9.5), 1),
           ("count", "coder.ahead", _at(11.5), _at(11.5), 1)]


def _read(r):
    return run._reader(REPO, "coder_ahead_pct").read(r)


def test_entry():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "coder_ahead_pct")
    assert entry == {"name": "coder_ahead_pct", "unit": "%",
                     "better": "higher", "source": "host_clock",
                     "layer": "flat host stage: IntraEncoder.host_finish",
                     "moves": "encode_fps"}


def test_hand_computed_value(monkeypatch):
    _planted(monkeypatch, FRAMES + AHEAD + OUTSIDE)
    assert _read(_run()) == pytest.approx(100.0 * 4 / 5, rel=1e-12)


def test_none_ahead_reads_zero(monkeypatch):
    _planted(monkeypatch, FRAMES + [r[:4] + (0,) for r in AHEAD])
    assert _read(_run()) == 0.0


def test_nothing_without_a_trace(monkeypatch):
    _planted(monkeypatch, FRAMES + AHEAD)
    assert _read(_run(trace=False)) is None


def test_nothing_without_the_counter(monkeypatch):
    _planted(monkeypatch, FRAMES + OUTSIDE[1:])
    assert _read(_run()) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import svtav1_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "svtav1_tpu_torch.utils.trace", None)
    assert _read(_run()) is None
