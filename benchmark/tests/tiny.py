"""A copy of the benchmark with a tiny cell added by files and entries
only, for the CPU tests (the 1080p cells are measured on the card)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = "tiny8.tiny-b2"


def tiny_root(tmp: Path, width: int = 256, height: int = 120,
              batch: int = 2, check_payloads: int = 4) -> Path:
    """tmp holding BENCHMARK.json and benchmark/ with a 8-bit flat
    configuration at width x height and a detail mix of `batch` frames a
    call over a pool of 4 added: the cell tiny8.tiny-b2."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark/configs/flat-ai-1080p8.json")
                     .read_text())
    cfg.update(name="tiny8", width=width, height=height)
    (tmp / "benchmark/configs/tiny8.json").write_text(json.dumps(cfg))
    mix = json.loads((REPO / "benchmark/traffic/detail-q110-b4.json")
                     .read_text())
    mix.update(name="tiny-b2", batch=batch, pool=4,
               check_payloads=check_payloads)
    (tmp / "benchmark/traffic/tiny-b2.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "tiny8", "source": "test",
                             "file": "benchmark/configs/tiny8.json",
                             "reduced": [], "why": "CPU test size"})
    bench["workloads"].append({"name": TINY, "config": "tiny8",
                               "traffic": "tiny-b2", "chips": 1,
                               "why": "CPU test size"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
