"""On the card: the edge strip cell's control on three seeds at the
cell's own size (the reference with its RD cost in bfloat16, strip
included, in the program's place, must fail the comparison that decides
`correct`)."""

import json

import pytest

from benchmark.pipelines import all_intra_edge
from benchmark.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]
         if next(json.loads((REPO / f["file"]).read_text())["pipeline"]
                 for f in BENCH["configs"] if f["name"] == c["config"])
         == "all_intra_edge"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_edge_control_fails_at_the_cells_size(card, workload):
    cell = next(c for c in BENCH["workloads"] if c["name"] == workload)
    cfg_file = next(c["file"] for c in BENCH["configs"]
                    if c["name"] == cell["config"])
    cfg = json.loads((REPO / cfg_file).read_text())
    mix = json.loads((REPO / "benchmark/traffic" /
                      f"{cell['traffic']}.json").read_text())
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        checks = all_intra_edge.control(cfg, mix, seed, card)
        print(workload, seed, {k: v for k, (v, _) in checks.items()})
        assert any(v > lim for v, lim in checks.values())
