"""A whole run, with the look for a card skipped and the timed path broken
underneath, comes out not correct: a step that leaves its state unchanged,
a step that sees half of each batch (its loss the mean over the rest),
answers altered where they are produced, and score logits negated where
the model produces them. Unbroken, the same run is correct. A run of the
data-parallel kind in which one rank has loaded JAX is refused."""

from __future__ import annotations

import sys
import time
import types

import pytest

from benchmark import calibrate, run
from benchmark.tests.small import CPU, small_cell


def _run(cell: str, wrap=None) -> dict:
    return run.execute(small_cell(cell), 2**31 + 99, 0.5, False, CPU, time.perf_counter(), wrap=wrap)


def test_sound_runs_are_correct():
    for cell in ("retina300.train.b128", "retina300.ground.c256", "retina300.train.dp4.b128"):
        res = _run(cell)
        assert res["correct"] and res["failed"] == 0, res["checks"]
        assert list(res)[-1] == "checks"


def test_state_left_unchanged_is_not_correct():
    res = _run("retina300.train.b128", lambda r: calibrate.plant(r, "unchanged"))
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == 1.0 and res["checks"]["grad_gap"]["value"] == 1.0


def test_half_of_the_batch_is_not_correct():
    res = _run("ssd300.train.b128", lambda r: calibrate.plant(r, "half_batch"))
    assert not res["correct"], res["checks"]


def test_altered_answers_are_not_correct():
    res = _run("retina300.ground.c256", lambda r: calibrate.plant(r, "shifted_answers"))
    assert not res["correct"], res["checks"]


def test_negated_scores_are_not_correct():
    res = _run("retina300.ground.c256", lambda r: calibrate.plant(r, "negated_scores"))
    assert not res["correct"], res["checks"]
    row = res["checks"]["box_ratio"]
    assert row["value"] > 10 * row["limit"], row


def _load_jax(_run) -> None:
    sys.modules["jax"] = types.ModuleType("jax")


def test_a_rank_that_loads_jax_is_refused():
    """Two gloo ranks on the CPU; rank 1 holds a module named ``jax``."""
    with pytest.raises(SystemExit, match=r"rank 1.*'jax'"):
        _run("retina300.train.dp4.b128", lambda r: r.plant(_load_jax, rank=1))
