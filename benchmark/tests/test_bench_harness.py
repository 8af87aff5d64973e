"""The harness finds every file by name, refuses an unknown one, and
``BENCHMARK.json`` keeps its schema and limits."""

from __future__ import annotations

import json
import math
import re

import pytest
import torch

from benchmark import harness, run

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["source"] and isinstance(c.config["reduced"], list)
    harness.port_config(c.config)
    assert hasattr(c.kind, "Run") and c.limits
    assert "setup_s" in {m["name"] for m in c.end_to_end} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError, match="no workload"):
        harness.load_cell("no.such.cell")
    with pytest.raises(FileNotFoundError, match="metrics"):
        harness.metric_reader("no_such_metric")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "no_such_mix"
    with pytest.raises(FileNotFoundError, match="traffic"):
        harness.load_cell(CELLS[0], bench)
    with pytest.raises(KeyError, match="configuration keys"):
        harness.port_config({"mdl_to_use": "retina", "not_a_setting": 1})


def test_run_names_no_cell_or_configuration():
    src = (harness.HERE / "run.py").read_text() + (harness.HERE / "harness.py").read_text()
    for name in CELLS + [c["name"] for c in BENCH["configs"]]:
        assert name not in src


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal without one")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA device" in out.err


def test_benchmark_json_keeps_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert harness.reports(e2e[m["moves"]], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_limits_are_finite_and_positive(cell):
    """Every limit is a finite positive number."""
    for k, v in harness.load_cell(cell).limits.items():
        assert math.isfinite(v) and v > 0, k
