"""The plain reference equals the system under test at a small size on the
CPU, retina and SSD-VGG16: the forward, the loss and one Adam step. (The
test imports the system; the reference does not.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.kinds.train import Run, make_ring
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model
from benchmark.tests.small import CPU, small_cell
from benchmark.weights import make_state


@pytest.mark.parametrize("cell", ["retina300.train.b128", "ssd300.train.b128"])
def test_forward_and_anchors_equal_the_program(cell):
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for

    from benchmark.harness import port_config

    c = small_cell(cell)
    cfg = c.config
    state = make_state(cfg, cfg["vocab_size"], 7, CPU)
    model = ZSGNet(port_config(cfg), cfg["vocab_size"]).eval()
    model.load_state_dict(state)
    b = make_ring(cfg, c.traffic, 7)[0]
    img, qvec, qlens = (torch.from_numpy(b[k]) for k in ("img", "qvec", "qlens"))
    with torch.no_grad():
        out = model(img, qvec, qlens)
        att, bbx = ref_model.forward(cfg, state, img, qvec, qlens)
    assert torch.allclose(out["att_out"], att, atol=1e-5, rtol=1e-5)
    assert torch.allclose(out["bbx_out"], bbx, atol=1e-5, rtol=1e-5)
    assert np.array_equal(anchor_pyramid_for(port_config(cfg)), ref_model.anchors(cfg, torch.float32).numpy())


@pytest.mark.parametrize("cell", ["retina300.train.b128", "ssd300.train.b128"])
def test_loss_and_adam_steps_equal_the_program(cell):
    c = small_cell(cell)
    run = Run(c.config, c.traffic, 2**31 + 3, CPU)
    run.build()
    run.prime()
    run.release()
    ref = run.reference()
    r = check.train_readings(run.readings, ref)
    # float32 on both sides; BatchNorm's backward over 16 values a channel
    # (layer4 at 64², batch 4) is where most of the round-off gathers.
    assert r["loss_gap"] < 5e-5 and r["grad_gap"] < 5e-3 and r["change_gap"] < 2e-2, r


def test_decode_and_loss_by_hand():
    cfg = {"matching_threshold": 0.5, "neg_threshold": 0.4, "lamb_reg": 1.0}
    anchors = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.5, 0.5, 0.5, 0.5], [-0.5, -0.5, 1.0, 1.0]])
    gt = torch.tensor([[-0.5, -0.5, 0.5, 0.5]])
    pos, counted = ref_loss.labels(cfg, anchors, gt)
    assert pos.tolist() == [[True, False, False]] and counted.tolist() == [[True, True, True]]
    deltas = ref_loss.encode(anchors, gt)
    assert torch.allclose(ref_loss.decode(anchors, deltas[0])[0], gt[0], atol=1e-6)
    att = torch.tensor([[2.0, -1.0, 3.0]])
    idx, box = ref_loss.decode_top(att, deltas, anchors)
    assert idx.tolist() == [2]
