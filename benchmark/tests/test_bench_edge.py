"""The edge strip's cell on the CPU at a tiny m = 12 size: the pipeline
``all_intra_edge`` added as files and entries runs correct, planted
faults in the strip and the payloads read correct false, the reference
equals the program's CPU path, the control fails, the three new readers
read their records and nothing without them, and the frozen work count
of the strip's kernel."""

import json

import numpy as np
import pytest
import torch
from unittest import mock

from benchmark import run
from benchmark.pipelines import all_intra, all_intra_edge
from benchmark.pipelines.all_intra import Window
from benchmark.reference import edge, encoder
from benchmark.tests.tiny import REPO, TINY, tiny_root
from benchmark.yardstick import clips, edgecount, workcount

MIX = json.loads((REPO / "benchmark/traffic/detail-q110-b4.json")
                 .read_text())
EDGE_CELL = "flat-ai-2160p10.detail-q110-b4"
S = 1_000_000_000
OFF = 7 * S


def edge_root(tmp, width=128, height=112, bd=8):
    """tiny_root's copy with its tiny cell at an m = 12 height on the edge
    pipeline."""
    root = tiny_root(tmp, width=width, height=height, check_payloads=2)
    p = root / "benchmark/configs/tiny8.json"
    cfg = json.loads(p.read_text())
    cfg.update(pipeline="all_intra_edge", bit_depth=bd)
    p.write_text(json.dumps(cfg))
    return root


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return edge_root(tmp_path)


def test_the_cell_is_declared():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(c for c in bench["workloads"] if c["name"] == EDGE_CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "detail-q110-b4"
    cfg_file = next(c["file"] for c in bench["configs"]
                    if c["name"] == cell["config"])
    cfg = json.loads((REPO / cfg_file).read_text())
    assert (cfg["width"], cfg["height"], cfg["bit_depth"]) == (3840, 2160,
                                                                10)
    assert cfg["pipeline"] == "all_intra_edge" and cfg["height"] % 64 == 48
    new = {m["name"]: m for m in bench["per_layer"]
           if m["name"].startswith("edge_")}
    assert set(new) == {"edge_enqueue_ms", "edge_device_ms",
                        "edge_roofline_pct"}
    for m in new.values():
        assert m["workloads"] == [EDGE_CELL] and m["moves"] == "encode_fps"


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_edge_cell_runs_correct(root, trace):
    # a window long enough to code the whole pool under a profiler on a
    # loaded CPU
    result, checks = run.run_cell(TINY, 2**31 + 123, 8.0, bool(trace),
                                  device="cpu", root=root)
    assert result["correct"] is True and result["failed"] == 0
    assert all(v == 0 for v, _ in checks.values())
    if trace:
        m = result["metrics"]
        assert m["edge_enqueue_ms"]["value"] > 0
        # no device events on the CPU
        assert "edge_device_ms" not in m and "edge_roofline_pct" not in m


def _broken(kind):
    from svtav1_tpu_torch.encoder.intra_encoder import IntraEncoder
    de, hf = IntraEncoder.device_encode, IntraEncoder.host_finish

    def strip_level(self, frames):
        out = de(self, frames)
        out["y_elev"][0, 1, 0, 0] += 1
        return out

    def strip_mode(self, frames):
        out = de(self, frames)
        out["uv_emi"][:, 2] = (out["uv_emi"][:, 2] + 1) % 13
        return out

    def payload(self, dev):
        payloads, recons = hf(self, dev)
        p = bytearray(payloads[0])
        p[len(p) // 2] ^= 4
        return [bytes(p)] + payloads[1:], recons

    if kind == "payload":
        return mock.patch.object(IntraEncoder, "host_finish", payload)
    return mock.patch.object(IntraEncoder, "device_encode",
                             {"strip_level": strip_level,
                              "strip_mode": strip_mode}[kind])


@pytest.mark.parametrize("kind", ["strip_level", "strip_mode", "payload"])
def test_planted_faults_come_out_incorrect(root, kind):
    with _broken(kind):
        result, checks = run.run_cell(TINY, 4321 + len(kind), 3.0, False,
                                      device="cpu", root=root)
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values())


@pytest.mark.parametrize("bd,w,h,q", [(8, 128, 112, 110), (10, 128, 112, 110),
                                      (8, 192, 48, 210), (10, 256, 176, 60)])
def test_reference_equals_port(bd, w, h, q):
    """The reference's device stage element for element and its payloads
    byte for byte against the program's CPU path at m = 12 sizes."""
    from svtav1_tpu_torch.encoder.intra_encoder import (EncoderConfig,
                                                        IntraEncoder)
    from svtav1_tpu_torch.encoder.presets import apply_preset
    torch.set_num_threads(2)
    frames = clips.make_pool(MIX["content"], w, h, bd, 2, 11 + q)
    enc = IntraEncoder(apply_preset(EncoderConfig(w, h, qindex=q,
                                                  bit_depth=bd), 12),
                       device="cpu")
    enc.host_finish(enc.device_encode(frames[:1]))   # the stream's first
    dev = enc.device_encode(frames)
    payloads, recons = enc.host_finish(dev)
    ref = {k: v.numpy() for k, v in
           edge.device_stage(frames, q, bd, h, "cpu").items()}
    assert set(ref) == set(all_intra._KEYS) | set(all_intra_edge.STRIP)
    for k, v in ref.items():
        assert np.array_equal(dev[k].to(torch.int32).numpy(), v), k
    lf = encoder.lf_levels(q)
    for b in range(2):
        strip = (ref["y_emi"][b], ref["uv_emi"][b], ref["y_elev"][b],
                 ref["uv_elev"][b], ref["uv_elev"][2 + b])
        want = edge.host_stage(ref["y_mi"][b], ref["uv_mi"][b],
                               ref["y_lev"][b], ref["uv_lev"][b],
                               ref["uv_lev"][2 + b], strip, w, h, q, lf,
                               True)
        assert payloads[b] == want
        assert np.array_equal(recons[b][0], ref["y_rec"][b][:h])


def test_control_comes_out_incorrect():
    """The control (the reference with a bfloat16 RD cost) fails the
    numbers on three seeds at a test size; the card test repeats it at
    the cell's size."""
    cfg = json.loads((REPO / "benchmark/configs/flat-ai-2160p10.json")
                     .read_text())
    cfg.update(width=256, height=176)
    mix = dict(MIX, pool=4, check_payloads=1)
    torch.set_num_threads(2)
    for seed in (1, 2**31 + 5, 77777):
        checks = all_intra_edge.control(cfg, mix, seed, "cpu")
        assert checks["device_mismatch"][0] > 0, seed


def _reader(name):
    return run._reader(REPO, name)


def _run(events=(), trace=True, edge_calls=None):
    w = Window(t0=10.0, t_end=11.0, frames=4)
    if edge_calls is not None:
        w.edge_calls = edge_calls
    tr = run.Trace(list(events), 1.0, 0.0, {}) if trace else None
    return run.Run(w, 1.0, 40.0, tr, 10)


def _planted(monkeypatch, recs):
    from svtav1_tpu_torch.utils import trace
    from svtav1_tpu_torch.utils.trace import Record
    monkeypatch.setattr(trace, "records",
                        lambda: [Record(*r) for r in recs])


@pytest.mark.parametrize("name", ["edge_enqueue_ms", "edge_device_ms",
                                  "edge_roofline_pct"])
def test_readers_read_nothing_without_a_strip(name, monkeypatch):
    """A 1080p run has no enc.edge or dev.edge span and no chain launch."""
    _planted(monkeypatch, [("host", "enc.deblock", 10 * S, 10 * S + 5, 0)])
    events = [("wf_plane_kernel", 10 * S + OFF, 10 * S + OFF + 1000)]
    assert _reader(name).read(_run(events)) is None
    assert _reader(name).read(_run(trace=False)) is None


def test_edge_enqueue_is_the_span_mean(monkeypatch):
    _planted(monkeypatch, [
        ("host", "enc.edge", int(10.1 * S), int(10.1 * S) + 2_000_000, 0),
        ("host", "enc.edge", int(10.5 * S), int(10.5 * S) + 4_000_000, 0),
        ("host", "enc.edge", int(11.5 * S), int(11.5 * S) + 9_000_000, 0)])
    assert _reader("edge_enqueue_ms").read(_run()) == pytest.approx(3.0)


def test_edge_device_counts_the_kernels_inside(monkeypatch):
    """dev.edge starts where its marker ends on the device timeline and
    counts only the chain kernel's events inside its length, not the copy
    stream's D2H beside it."""
    from svtav1_tpu_torch.utils.trace import MARK
    _planted(monkeypatch, [("device", "dev.edge", int(10.1 * S),
                            int(10.1 * S) + 10_000_000, 1)])
    m = int(10.2 * S) + OFF
    events = [(MARK, m - 2000, m),
              ("wf_edge_kernel", m + 1_000_000, m + 4_000_000),
              ("wf_edge_kernel", m + 5_000_000, m + 7_500_000),
              ("Memcpy DtoH (Device -> Pageable)", m + 500_000,
               m + 9_000_000),
              ("deblock", m + 12_000_000, m + 13_000_000)]
    assert _reader("edge_device_ms").read(_run(events)) == \
        pytest.approx(5.5)


def test_edge_roofline_is_the_least_time_over_the_kernel_time():
    calls = [(32, 4, 3840, False), (16, 8, 1920, True)]
    least = sum(edgecount.least_seconds(*c, 10) for c in calls)
    events = [("void wf_edge_kernel<unsigned short>", 0, 2_000_000),
              ("void wf_edge_kernel<unsigned short>", 5_000_000, 9_000_000),
              ("wf_plane_kernel", 0, 50_000_000)]
    got = _reader("edge_roofline_pct").read(_run(events, edge_calls=calls))
    assert got == pytest.approx(100 * least / 6e-3)
    assert 0 < got < 100


def test_edgecount_by_hand():
    """Luma: 13 DCT_DCT candidates at 106.25 operations a pixel on the 32
    rows of big blocks and at (190 + 190 + 286 + 286) / 16 + 30 = 89.5 on
    the 16 strip rows; chroma: the plane kernel's 16x16 count on 16 rows
    and the 8x8 networks on 8."""
    assert edgecount.ops_per_pixel(32, workcount.LUMA_KINDS) == 13 * 106.25
    assert edgecount.ops_per_pixel(16, workcount.LUMA_KINDS) == 13 * 89.5
    # 8x8: DCT_DCT (70 + 70 + 102 + 102) / 8 + 30 = 73, one ADST (70 + 111
    # + 143 + 102) / 8 + 30 = 83.25, ADST_ADST (111 + 111 + 143 + 143) / 8
    # + 30 = 93.5; 2, 8 and 3 of them as at 16x16
    assert edgecount.ops_per_pixel(8, workcount.CHROMA_KINDS) == \
        2 * 73 + 8 * 83.25 + 3 * 93.5
    ops, nbytes = edgecount.work(32, 4, 3840, False, 10)
    assert ops == int(13 * 106.25 * 4 * 32 * 3840 + 13 * 89.5 * 4 * 16 *
                      3840)
    assert nbytes == 4 * 48 * 3840 * 10


@pytest.mark.parametrize("big,B,w,chroma,bd", [(32, 4, 3840, False, 10),
                                               (16, 8, 1920, True, 10),
                                               (32, 2, 256, False, 8)])
def test_edgecount_is_the_programs(big, B, w, chroma, bd):
    from svtav1_tpu_torch.cuda import edge_kernel
    from svtav1_tpu_torch.encoder.intra_encoder import CAND_MODES
    assert edgecount.work(big, B, w, chroma, bd) == edge_kernel.edge_work(
        big, B, w, CAND_MODES, chroma, bd)
