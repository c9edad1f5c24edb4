"""On the card: the program's spans (``svtav1_tpu_torch/utils/trace.py``)
and the profiler's device events share one clock.  One flat batch under a
CPU and CUDA profiler: the kineto epoch is ``time.time_ns()``'s, each
stage span mapped with ``to_profiler_ns`` lies on its ``svt.<name>``
mirror, no mirror lands on the device's timeline, the batch's kernels
start inside its launch-to-copy interval, the deblock's device time as
``deblock_device_ms`` reads it (the device events inside the span, placed
by its marker kernel) equals that of the kernels launched inside the
``svt.enc.deblock`` mirror (kineto's correlation ids), and the D2H counter
reads what it should.

    python3 -m pytest benchmark/tests/test_bench_trace_card.py -m card \
        -o addopts="" -q -s
"""

import time

import pytest
import torch

pytestmark = pytest.mark.card

STAGES = ("enc.stage", "enc.upload", "enc.launch", "enc.deblock",
          "fin.wait", "fin.d2h", "fin.coder", "fin.obu")


def test_spans_share_the_device_clock(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from svtav1_tpu_torch.cuda import inputs
    from svtav1_tpu_torch.encoder.intra_encoder import (_D2H, EncoderConfig,
                                                        IntraEncoder)
    from svtav1_tpu_torch.utils import trace

    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(card))
    enc = IntraEncoder(EncoderConfig(512, 256, qindex=110,
                                     part_search=False), device=card)
    frames = inputs.moving_frames(512, 256, 4)
    enc.host_finish(enc.device_encode(frames))
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = time.time_ns()
        t0 = time.perf_counter_ns()
        dev = enc.device_encode(frames)
        enc.host_finish(dev)
        t1 = time.perf_counter_ns()
        b = time.time_ns()
        # a user-scope annotation, for comparison with the mirrors
        with torch.profiler.record_function("user.scope"):
            torch.ones(1, device=card).add_(1)
        torch.cuda.synchronize(card)
    raw = list(prof.profiler.kineto_results.events())
    evs = [(e.name(), e.device_type(), e.start_ns(),
            e.start_ns() + e.duration_ns()) for e in raw]
    recs = [r for r in trace.records() if t0 <= r.start_ns <= t1]
    svt = [e for e in evs if e[0].startswith("svt.")]
    print("user-scope annotation's device types:",
          sorted({str(d) for n, d, _, _ in evs if n == "user.scope"}))
    assert svt and all(d == DeviceType.CPU for _, d, _, _ in svt)
    # kineto's epoch is time.time_ns()'s
    assert all(a <= s <= e <= b for _, _, s, e in svt)
    mirror = {}
    for n, _, s, e in sorted(svt, key=lambda ev: ev[2]):
        mirror.setdefault(n[4:], []).append((s, e))
    host = sorted((r for r in recs if r.kind == "host"),
                  key=lambda r: r.start_ns)
    spans = {}
    for r in host:
        spans.setdefault(r.name, []).append(r)
    for name in STAGES:
        # upload and launch once a plane
        assert len(spans[name]) == len(mirror[name]) == \
            (2 if name in ("enc.upload", "enc.launch") else 1), name
        for r, (s, e) in zip(spans[name], mirror[name]):
            print(f"{name}: start {trace.to_profiler_ns(r.start_ns) - s} "
                  f"ns, end {trace.to_profiler_ns(r.end_ns) - e} ns off its "
                  "mirror")
            assert abs(trace.to_profiler_ns(r.start_ns) - s) < 500_000, name
            assert abs(trace.to_profiler_ns(r.end_ns) - e) < 500_000, name
    spans = {name: rs[0] for name, rs in spans.items()}
    # the batch's kernels run after its launch span starts and end before
    # its copies do
    kern = [(s, e) for n, d, s, e in evs
            if d == DeviceType.CUDA and "wf_plane_kernel" in n]
    assert len(kern) == 2
    lo = trace.to_profiler_ns(spans["enc.launch"].start_ns)
    hi = trace.to_profiler_ns(spans["fin.d2h"].end_ns)
    assert all(lo <= s and e <= hi for s, e in kern)
    deblock = [r for r in recs if r.name == "dev.deblock"]
    assert len(deblock) == 1 and 0 < deblock[0].end_ns - \
        deblock[0].start_ns < 10**9 and deblock[0].n == 1
    # the reader's device time against that of the kernels launched
    # inside the svt.enc.deblock mirror, by correlation id
    from benchmark import run
    from benchmark.pipelines.all_intra import Window
    from benchmark.yardstick import stats
    dev_evs = [(n, s, e) for n, d, s, e in evs if d == DeviceType.CUDA]
    w = Window(t0=t0 / 1e9, t_end=t1 / 1e9, frames=len(frames))
    got = run._reader(run.ROOT, "deblock_device_ms").read(
        run.Run(w, 0.0, 0.0, run.Trace(dev_evs, 0.0, 0.0, {}), 8))
    (ms, me), = mirror["enc.deblock"]
    # the runtime and driver calls (cudaLaunchKernel, cudaMemcpyAsync...):
    # their ids are those of the device events they started
    launched = {e.correlation_id() for e in raw
                if e.device_type() == DeviceType.CPU
                and e.name().startswith("cu") and ms <= e.start_ns() <= me}
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in raw
               if e.device_type() == DeviceType.CUDA
               and e.correlation_id() in launched]
    want = stats.busy_union(kernels) / 1e6
    print(f"deblock device time: reader {got} ms, kernels launched inside "
          f"the mirror {want} ms ({len(kernels)} device events), span "
          f"{(deblock[0].end_ns - deblock[0].start_ns) / 1e6} ms")
    assert kernels and got == pytest.approx(want, rel=0.05, abs=0.02)
    d2h = [r.n for r in recs if r.kind == "count" and r.name == "d2h.bytes"]
    assert d2h == [sum(dev[k].nbytes for k in _D2H)]
