"""The control fails the comparison that the program passes, at a size a
test run holds: for training, the reference in the program's place with
float8 (e4m3) convolution operands; for grounding, the program's own int8
serving path. Both against the cells' own limits. The grounding comparison
holds the anchor that the decode picks and the served score with the box. (On the card the control
was read at the cells' own sizes; ``PERF.md`` gives those readings.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import check
from benchmark.kinds.ground import Run as GroundRun
from benchmark.kinds.train import Run as TrainRun
from benchmark.reference import loss as ref_loss
from benchmark.tests.small import CPU, small_cell


@pytest.mark.parametrize("cell", ["retina300.train.b128", "ssd300.train.b128"])
def test_fp8_control_fails_where_the_program_passes(cell):
    c = small_cell(cell)
    run = TrainRun(c.config, c.traffic, 11, CPU)
    run.build()
    run.prime()
    run.release()
    ref = run.reference()
    ok, table = check.verdict(check.train_readings(run.readings, ref), c.limits)
    assert ok, table
    ok, table = check.verdict(check.train_readings(run.reference(conv=check.fp8_conv), ref), c.limits)
    assert not ok, table


def test_int8_control_fails_where_the_program_passes():
    readings = {}
    for quantize in (False, True):
        c = small_cell("retina300.ground.c256", batch_size=32, clients=64, sample=32)
        c.traffic["quantize"] = quantize
        run = GroundRun(c.config, c.traffic, 13, CPU)
        run.build()
        run.prime()
        run.window(0.5)
        readings[quantize] = check.verdict(run.check(), c.limits)
    assert readings[False][0], readings[False][1]
    assert not readings[True][0], readings[True][1]


def test_ground_readings_hold_the_anchor_and_the_score():
    """``box_rel`` (``box_ratio``'s numerator) over answers built from the
    reference itself: its own answers and a near-tied anchor's read 0; the
    worst anchor's box, or the right box with another score, read at least
    the boxes' whole move."""
    g = torch.Generator().manual_seed(3)
    n, a = 5, 40
    att = -4.6 + torch.randn(n, a, generator=g)
    att[:, 1] = att.amax(dim=1) + 0.5  # a clear best ...
    att[:, 2] = att[:, 1] - 0.05  # ... and a runner-up within bf16's rounding of it
    anchors = torch.cat([torch.rand(a, 2, generator=g) - 0.5, 0.2 + 0.3 * torch.rand(a, 2, generator=g)], dim=1)
    boxes = ref_loss.cthw_to_tlbr(anchors)[None].repeat(n, 1, 1) + 0.05 * torch.randn(n, a, 4, generator=g)
    rows = torch.arange(n)

    boxes_bf16 = boxes + 1e-3 * torch.randn(n, a, 4, generator=g)

    def box_rel(pick, logit):
        out = check.ground_readings(att, boxes, boxes[rows, pick], torch.sigmoid(logit), anchors, boxes_bf16)
        assert out["box_ratio"] == out["box_rel"] / out["box_rel_bf16"]
        return out

    best = att.argmax(dim=1)
    sound = box_rel(best, att[rows, best])
    assert sound["box_rel"] == 0 and sound["missed_share"] == 0
    assert box_rel(torch.full((n,), 2), att[:, 2])["box_rel"] == 0
    worst = att.argmin(dim=1)
    assert box_rel(worst, att[rows, best])["box_rel"] >= 1
    assert box_rel(worst, att[rows, worst])["box_rel"] >= 1
    wrong_score = box_rel(best, att[rows, best] + 1.0)
    assert wrong_score["missed_share"] == 1 and wrong_score["box_rel"] >= 1
