"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the root of the
checkout; its configuration file (``file``), its traffic mix
(``traffic/<traffic>.json``) and every metric's reader
(``metrics/<name>.py``) are found by the names given there, and the
configuration names the pipeline (``pipelines/<pipeline>.py``) that drives
the program.  A cell, a mix or a metric is added by adding files and
entries.

The run: set-up (imports, the card, the program's encoder, the source pool
from the seed, a warm-up of every shape), then the measured window, then
the check of what the window produced against the plain reference in
``reference/``.  With ``--trace 0`` the result line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window and the harness's own spans.  The
numbers compared, each with its limit, are the last lines on standard
error and the last key of the result line, which is the last line of
standard output.  The run fails, and prints no result, without a CUDA
card, or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                       # noqa: E402
import importlib                                      # noqa: E402
import importlib.util                                 # noqa: E402
import json                                           # noqa: E402
import sys                                            # noqa: E402
import threading                                      # noqa: E402
from dataclasses import dataclass                     # noqa: E402
from pathlib import Path                              # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "svtav1_tpu")


@dataclass
class Spec:
    cell: dict
    config: dict
    traffic: dict
    metrics: list          # [(name, unit, reader module)]


@dataclass
class Trace:
    device_events: list    # (name, start ns, end ns)
    window_s: float
    busy_s: float
    breakdown: dict


@dataclass
class Run:
    window: object
    setup_s: float
    psnr_y: float
    trace: Trace
    bit_depth: int


def _reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(root: Path, workload: str, trace: bool) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    metrics = [(m["name"], m["unit"], _reader(root, m["name"]))
               for m in bench[kind]]
    return Spec(cell, config, traffic, metrics)


def _trace(prof) -> Trace:
    """Device events, the window (the bench.window annotation), the busy
    union inside it and the breakdown, from the profiler's raw events."""
    from torch.autograd import DeviceType

    from benchmark.yardstick import stats
    dev, notes = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.name().startswith("bench."):
            # the harness's own spans; the profiler also mirrors each on
            # the device's timeline, where it is no device work
            if e.device_type() != DeviceType.CUDA:
                notes.append((e.name()[6:], s, s + d))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), s, s + d))
    t0, t1 = next((s, e) for n, s, e in notes if n == "window")
    clipped = [(max(s, t0), min(e, t1)) for _, s, e in dev
               if e > t0 and s < t1]
    busy = stats.busy_union(clipped) / 1e9
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = [(n, s, e) for n, s, e in notes if n != "window"]
    gaps = []
    for s, e in stats.idle_gaps(clipped, t0, t1):
        label = next((n for n, a, b in spans if a <= s < b), "loop")
        gaps.append((label, (e - s) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return Trace(dev, (t1 - t0) / 1e9, busy,
                 {"device_ops": [list(o) for o in ops],
                  "idle_gaps": [list(g) for g in gaps[:10]]})


def _python_ms() -> float:
    """Milliseconds of a fixed pure-Python loop: the speed this process
    gets from the host's CPU at the moment."""
    t = time.perf_counter()
    s = 0
    for i in range(200_000):
        s += i
    return 1e3 * (time.perf_counter() - t)


def _host(threads: int, before_ms: float) -> str:
    """The host as the window saw it: the CPUs this process may use, its
    threads, the load, and the fixed loop's time before and after."""
    import os

    import torch
    try:
        load = Path("/proc/loadavg").read_text().split()[0]
    except OSError:
        load = "unknown"
    return (f"host: cpus {len(os.sched_getaffinity(0))} of "
            f"{os.cpu_count()}, torch threads {torch.get_num_threads()}, "
            f"threads after the window {threads}, load {load}, "
            f"fixed loop {before_ms:.2f} ms before the window, "
            f"{_python_ms():.2f} ms after")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float = T_START):
    """One run of one cell: (the result object, {check: (value, limit)})."""
    import torch
    spec = load(root, workload, trace)
    pipe = importlib.import_module(
        f"benchmark.pipelines.{spec.config['pipeline']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cell = pipe.Cell(spec.config, spec.traffic, seed, device)
    cell.warm_up()
    host_ms = _python_ms()
    setup_s = time.perf_counter() - t_start
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            w = cell.window(seconds, trace=True)
        tr = _trace(prof)
    else:
        w = cell.window(seconds)
    host = _host(threading.active_count(), host_ms)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    prog = cell.program_outputs(w)
    w.dev.clear()
    cell.free_program()
    run = Run(w, setup_s, cell.psnr_y(w), tr, spec.config["bit_depth"])
    t_check = time.perf_counter()
    ref = cell.reference()
    checks = cell.check(w, prog, ref)
    print(f"phases: set-up {setup_s:.3f} s, window {w.t_end - w.t0:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    print(host, file=sys.stderr)
    metrics = {}
    for name, unit, reader in spec.metrics:
        v = reader.read(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": spec.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": w.frames, "failed": cell.failed(w, checks),
              "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    chips = load(ROOT, args.workload, False).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    # one intra-op thread: the window's CPU work is the coder's threads and
    # the launches on the main thread; idle OpenMP workers spinning beside
    # them took 1.3 cores of the card's 8 and jittered each call
    torch.set_num_threads(1)
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    emit(result, checks)
    return 0


def emit(result: dict, checks: dict) -> None:
    """The numbers compared, then the result line, last on their
    streams."""
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
