"""Each cell once on the card, briefly, traced: correct, with every
per-layer metric it lists. Run on a machine with the card:

    python -m pytest benchmark/tests/test_bench_cuda.py -m cuda
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness, run

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    c = harness.load_cell(cell)
    if torch.cuda.device_count() < c.chips:
        pytest.skip(f"{cell} needs {c.chips} cards")
    res = run.execute(c, 2**31 + 5, 2.0, True, card, time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in c.per_layer}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
