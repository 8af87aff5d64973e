"""The port's evaluation step against the JAX ``make_eval_step`` on the same
weights and batch, with the reference's flat layout
(``use_level_path=False``): per-sample ``correct``/``max_pos`` exact,
``iou`` and ``pred_box`` to 1e-5, the ``valid``-weighted loss to rtol 1e-4
(float32 sums in another order and across frameworks). The port sends the
focal multi-positive loss through the fused loss's plain version on the
CPU; the JAX step off the TPU takes its jnp loss, the fused kernel's
oracle. The evaluators then summarize and dump alike."""

import json

import jax
import numpy as np
import pytest
import torch

from _torch_port import cfg_pair, jax_variables, port_model, random_batch
from zsgnet_tpu.models.zsgnet import anchor_pyramid_for as j_anchor_pyramid, get_default_net
from zsgnet_tpu.parallel.train_step import create_train_state, make_eval_step as j_make_eval_step
from zsgnet_tpu.train.evaluator import Evaluator as JEvaluator
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for
from zsgnet_tpu_torch.parallel.train_step import make_eval_step
from zsgnet_tpu_torch.train.evaluator import Evaluator

torch.set_num_threads(1)

VOCAB = 30


@pytest.fixture(scope="module")
def results():
    jcfg, tcfg = cfg_pair(use_pallas=True, bs=4)
    variables = jax_variables(jcfg, VOCAB, seed=1)
    rng = np.random.default_rng(11)
    batch = random_batch(rng, 4, tcfg, VOCAB)
    batch["annot"][3] = (-1.0, -1.0, 1.0, 1.0)
    batch["valid"] = np.array([True, True, True, False])
    batch["case"] = np.array([0, 1, 0, 1], np.int32)
    batch["idxs"] = np.arange(4, dtype=np.int32)

    model = get_default_net(jcfg, vocab_size=VOCAB)
    dev = {k: batch[k] for k in ("img", "qvec", "qlens", "annot")}
    state = create_train_state(jcfg, model, dev, jax.random.PRNGKey(0))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    want = j_make_eval_step(jcfg, j_anchor_pyramid(jcfg), mesh=None)(
        state, {**dev, "valid": batch["valid"]})
    want = {k: np.asarray(v) for k, v in want.items()}

    step = make_eval_step(tcfg, anchor_pyramid_for(tcfg), device="cpu")
    got = step(port_model(tcfg, variables, VOCAB), batch)
    got = {k: v.numpy() for k, v in got.items()}
    return batch, got, want


def test_eval_step_matches_jax(results):
    _, got, want = results
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["correct"], want["correct"])
    np.testing.assert_array_equal(got["max_pos"], want["max_pos"])
    np.testing.assert_allclose(got["iou"], want["iou"], atol=1e-5)
    np.testing.assert_allclose(got["pred_box"], want["pred_box"], atol=1e-5)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_evaluator_matches_jax(results, tmp_path):
    batch, got, want = results
    t_ev, j_ev = Evaluator(0.5), JEvaluator(0.5)
    for _ in range(2):  # two batches, the second one all valid
        t_ev.update(got, batch["case"], batch["idxs"], batch["valid"])
        j_ev.update(want, batch["case"], batch["idxs"], batch["valid"])
        batch = {**batch, "valid": np.ones(4, bool)}
    t_sum, j_sum = t_ev.summarize(), j_ev.summarize()
    assert set(t_sum) == set(j_sum) >= {"Acc", "MaxPos", "MeanIoU", "loss", "Acc_case_0", "Acc_case_1"}
    for k in t_sum:
        np.testing.assert_allclose(t_sum[k], j_sum[k], rtol=1e-4, err_msg=k)
    t_ev.dump_predictions(str(tmp_path / "port.jsonl"))
    j_ev.dump_predictions(str(tmp_path / "jax.jsonl"))
    t_rows = [json.loads(x) for x in (tmp_path / "port.jsonl").read_text().splitlines()]
    j_rows = [json.loads(x) for x in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert len(t_rows) == len(j_rows) == 7
    for t, j in zip(t_rows, j_rows):
        assert (t["id"], t["correct"]) == (j["id"], j["correct"])
        np.testing.assert_allclose(t["pred_box"], j["pred_box"], atol=1e-5)


@pytest.mark.parametrize("variant", [
    dict(use_focal=False), dict(use_softmax=True), dict(use_multi=False),
], ids=["bce", "softmax", "single_pos"])
def test_eval_step_loss_dispatch_matches_eager_loss(variant):
    """Every other loss variant goes through the eager loss, which
    tests/test_torch_ops.py holds against the JAX one."""
    from zsgnet_tpu_torch.models.zsgnet import get_default_net as t_net
    from zsgnet_tpu_torch.ops import anchors as anchor_ops, losses
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss

    _, tcfg = cfg_pair(**variant)
    model = t_net(tcfg, VOCAB, seed=2, device="cpu")
    batch = random_batch(np.random.default_rng(12), 3, tcfg, VOCAB)
    batch["valid"] = np.array([True, False, True])
    anchors = anchor_pyramid_for(tcfg)
    launches = fused_match_loss.launches
    ev = make_eval_step(tcfg, anchors, device="cpu")(model, batch)
    with torch.no_grad():
        out = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
    annot = torch.from_numpy(batch["annot"])
    labels, reg = anchor_ops.match_and_encode(torch.from_numpy(anchors), annot,
                                              use_multi=tcfg.use_multi)
    want = losses.zsg_loss(out["att_out"], out["bbx_out"], labels, reg,
                           use_focal=tcfg.use_focal, use_softmax=tcfg.use_softmax,
                           sample_weight=torch.tensor([1.0, 0.0, 1.0]))
    np.testing.assert_allclose(ev["loss"].numpy(), float(want["total"]), rtol=1e-6)
    assert fused_match_loss.launches == launches
