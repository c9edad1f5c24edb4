"""The harness end to end on the CPU at a tiny size: a configuration, a
traffic mix and a per-layer metric added as new files (and entries) in a
copy, the result line in the contract's shape, and correct coming out
false under each fault the timed path can have."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout
from unittest import mock

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import TINY, tiny_root

READER = '''"""Frames the window counted (a test's added metric)."""


def read(run):
    return float(run.window.frames)
'''


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny_root(tmp_path)


def _bench(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_added_files_run_and_print_a_contract_line(root):
    (root / "benchmark/metrics/frames_counted.py").write_text(READER)
    bench = _bench(root)
    bench["per_layer"].append({
        "name": "frames_counted", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "pipeline: the overlapped loop",
        "moves": "encode_fps"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (0, 1):
        result, checks = run.run_cell(TINY, 2**31 + 99, 3.0, bool(trace),
                                      device="cpu", root=root)
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            run.emit(result, checks)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] >= 4
        assert err.getvalue().strip().splitlines()[-1].startswith("check ")
        names = {m["name"] for m in bench["per_layer" if trace
                                         else "end_to_end"]}
        assert set(line["metrics"]) <= names
        if trace:
            assert line["metrics"]["frames_counted"]["value"] == \
                line["attempted"]
            assert "breakdown" in line and "window_s" in line["device"]
        else:
            assert set(line["metrics"]) == names
            for m in line["metrics"].values():
                assert m["value"] > 0


def _broken(kind):
    """A fault in the timed path, planted under the harness."""
    from svtav1_tpu_torch.encoder.intra_encoder import IntraEncoder
    de, hf = IntraEncoder.device_encode, IntraEncoder.host_finish
    state = {}

    def stale(self, frames):          # a step that returns its state
        out = de(self, frames)
        prev = state.get("dev")
        state["dev"] = out
        return out if prev is None else dict(prev, frames=frames)

    def half(self, frames):           # half of the batch left out
        n = len(frames) // 2
        out = de(self, frames[:n] + frames[:len(frames) - n])
        return dict(out, frames=frames)

    def level(self, frames):          # an answer altered where produced
        out = de(self, frames)
        out["y_lev"][0, 0, 0, 0, 0] += 1
        return out

    def payload(self, dev):           # a byte altered where produced
        payloads, recons = hf(self, dev)
        p = bytearray(payloads[-1])
        p[-1] ^= 1
        return payloads[:-1] + [bytes(p)], recons

    if kind == "payload":
        return mock.patch.object(IntraEncoder, "host_finish", payload)
    return mock.patch.object(IntraEncoder, "device_encode",
                             {"stale": stale, "half": half,
                              "level": level}[kind])


@pytest.mark.parametrize("kind", ["stale", "half", "level", "payload"])
def test_faults_come_out_incorrect(root, kind):
    with _broken(kind):
        result, checks = run.run_cell(TINY, 12345 + len(kind), 4.0, False,
                                      device="cpu", root=root)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(v > lim for v, lim in checks.values())


def test_control_comes_out_incorrect():
    """The control (the reference with a bfloat16 RD cost in the
    program's place) fails the numbers on three seeds at a size that a
    test run holds; the card test repeats it at the cells' size."""
    from benchmark.pipelines import all_intra
    from benchmark.tests.tiny import REPO
    cfg = json.loads((REPO / "benchmark/configs/flat-ai-1080p8.json")
                     .read_text())
    cfg.update(width=256, height=128)
    mix = json.loads((REPO / "benchmark/traffic/detail-q110-b4.json")
                     .read_text())
    mix.update(pool=4, check_payloads=1)
    torch.set_num_threads(2)
    for seed in (1, 2**31 + 5, 77777):
        checks = all_intra.control(cfg, mix, seed, "cpu")
        assert checks["device_mismatch"][0] > 0, seed
