"""The stage_reuse_pct reader on planted records: nothing without a trace,
without the recorder, or from a program that has no stage.reused counter
(as before device_encode staged into reused host slots); else the
window's stage.reused total over its enc.stage spans, in %."""

import json
import sys

import pytest

from benchmark import run
from benchmark.tests.test_bench_program_trace import _at, _planted, _run
from benchmark.tests.tiny import REPO

CALLS = [("host", "enc.stage", _at(t), _at(t + 0.01), 0)
         for t in (10.1, 10.3, 10.5, 10.7)]
REUSED = [("count", "stage.reused", _at(t), _at(t), n)
          for t, n in ((10.1, 1), (10.3, 1), (10.5, 0), (10.7, 1))]
# outside the window [10 s, 11 s]: left out
OUTSIDE = [("host", "enc.stage", _at(9.5), _at(9.51), 0),
           ("count", "stage.reused", _at(9.5), _at(9.5), 0),
           ("count", "stage.reused", _at(11.5), _at(11.5), 1)]


def _read(r):
    return run._reader(REPO, "stage_reuse_pct").read(r)


def test_entry():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = bench["per_layer"][-1]
    assert entry == {"name": "stage_reuse_pct", "unit": "%",
                     "better": "higher", "source": "host_clock",
                     "layer": "flat device stage: IntraEncoder.device_encode",
                     "moves": "encode_fps"}


@pytest.mark.parametrize("recs, want", [
    (CALLS + REUSED + OUTSIDE, 100.0 * 3 / 4),
    (CALLS + [r[:4] + (1,) for r in REUSED], 100.0),
    (CALLS + [r[:4] + (0,) for r in REUSED], 0.0),
], ids=["three-of-four", "all", "none"])
def test_hand_computed_value(monkeypatch, recs, want):
    _planted(monkeypatch, recs)
    assert _read(_run()) == pytest.approx(want, rel=1e-12)


def test_nothing_without_a_trace(monkeypatch):
    _planted(monkeypatch, CALLS + REUSED)
    assert _read(_run(trace=False)) is None


def test_nothing_without_the_counter(monkeypatch):
    _planted(monkeypatch, CALLS + OUTSIDE[2:])
    assert _read(_run()) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    import svtav1_tpu_torch.utils as utils
    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "svtav1_tpu_torch.utils.trace", None)
    assert _read(_run()) is None
