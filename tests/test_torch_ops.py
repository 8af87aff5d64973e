"""Port ops against the JAX package: box geometry, the anchor pyramid and
matching (labels exact, floats to 1e-6), every eager loss variant, and the
fused match + loss — the port's plain version of kernel K1 and its
``zsg_loss_fused`` on the CPU against the JAX Pallas kernel in interpret
mode (rtol 2e-5, the float32 sum-order budget tests/test_pallas.py uses)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zsgnet_tpu.ops import anchors as j_anchors, boxes as j_boxes, losses as j_losses
from zsgnet_tpu.ops.pallas.fused_loss import pack_anchors as j_pack, zsg_loss_fused as j_fused
from zsgnet_tpu_torch.ops import anchors as t_anchors, boxes as t_boxes, losses as t_losses
from zsgnet_tpu_torch.ops.cuda import fused_loss as t_fused

torch.set_num_threads(1)


def _boxes(rng, n):
    lo = rng.uniform(-1.2, 0.8, size=(n, 2))
    b = np.concatenate([lo, lo + rng.uniform(0.0, 1.0, size=(n, 2))], axis=1)
    b[0] = (0.1, 0.1, 0.1, 0.1)  # degenerate: zero extent
    return b.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("fn", ["tlbr2cthw", "cthw2tlbr", "box_area_tlbr", "clip_boxes"])
def test_unary_box_ops_match_jax(fn):
    b = _boxes(np.random.default_rng(1), 64)
    got = getattr(t_boxes, fn)(_t(b)).numpy()
    want = np.asarray(getattr(j_boxes, fn)(jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["iou_pairwise", "iou_aligned", "bbox_to_reg_params",
                                "reg_params_to_bbox", "scale_boxes_to_pixels"])
def test_binary_box_ops_match_jax(fn):
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 32), _boxes(rng, 32)
    b[1] = a[1]  # identical pair
    args = {
        "iou_pairwise": (a, b[:7]),
        "iou_aligned": (a, b),
        "bbox_to_reg_params": (t_boxes.tlbr2cthw(_t(a)).numpy(), b),
        "reg_params_to_bbox": (t_boxes.tlbr2cthw(_t(a)).numpy(), rng.normal(0, 3, (32, 4))),
        "scale_boxes_to_pixels": (a, rng.uniform(10, 500, (32, 2))),
    }[fn]
    args = [np.asarray(x, np.float32) for x in args]
    got = getattr(t_boxes, fn)(*map(_t, args)).numpy()
    want = np.asarray(getattr(j_boxes, fn)(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("img", [(64, 64), (300, 300), (96, 160)])
def test_anchor_pyramid_matches_jax(img):
    sizes = t_anchors.feature_map_sizes(img)
    assert sizes == j_anchors.feature_map_sizes(img)
    for hw in sizes:
        np.testing.assert_array_equal(t_anchors.create_grid(hw), j_anchors.create_grid(hw))
    scales, ratios = (1.0, 2 ** (1 / 3), 2 ** (2 / 3)), (0.5, 1.0, 2.0)
    np.testing.assert_array_equal(
        t_anchors.create_anchors(scales, ratios, sizes),
        j_anchors.create_anchors(scales, ratios, sizes),
    )


@pytest.mark.parametrize("use_multi", [True, False])
def test_match_and_encode_matches_jax(use_multi):
    anchors = t_anchors.create_anchors((1.0, 1.26), (0.5, 1.0, 2.0),
                                       t_anchors.feature_map_sizes((64, 64)))
    gt = _boxes(np.random.default_rng(3), 8)
    gt[1] = (-1.0, -1.0, 1.0, 1.0)  # the whole frame
    gt[2] = t_boxes.cthw2tlbr(_t(anchors[5])).numpy()  # exactly one anchor
    labels, reg = t_anchors.match_and_encode(_t(anchors), _t(gt), 0.5, 0.4, use_multi=use_multi)
    j_labels, j_reg = j_anchors.match_and_encode(
        jnp.asarray(anchors), jnp.asarray(gt), 0.5, 0.4, use_multi=use_multi)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(reg.numpy(), np.asarray(j_reg), atol=1e-6, rtol=1e-6)
    assert labels.dtype == torch.int32 and (labels == 1).any(dim=-1).all()


def _loss_setup(rng, b=8):
    """The JAX Pallas tests' inputs (tests/test_pallas.py::_setup)."""
    sizes = t_anchors.feature_map_sizes((64, 64), strides=(8, 16, 32))
    anchors = t_anchors.create_anchors((1.0, 1.26), (0.5, 1.0, 2.0), sizes)
    a = anchors.shape[0]
    att = rng.normal(size=(b, a)).astype(np.float32) * 2
    bbx = rng.normal(size=(b, a, 4)).astype(np.float32)
    gt = rng.uniform(-1, 1, size=(b, 4)).astype(np.float32)
    gt = np.concatenate(
        [np.minimum(gt[:, :2], gt[:, 2:]), np.maximum(gt[:, :2], gt[:, 2:]) + 0.05], axis=1
    )
    return anchors, att, bbx, gt


WEIGHTS = {"unweighted": None, "weighted": np.array([1, 0, 1, 1, 1, 0, 1, 1], np.float32)}


@pytest.mark.parametrize("variant", [
    dict(use_focal=True, use_softmax=False, use_multi=True),
    dict(use_focal=False, use_softmax=False, use_multi=True),
    dict(use_focal=True, use_softmax=True, use_multi=True),
    dict(use_focal=True, use_softmax=False, use_multi=False),
], ids=["focal", "bce", "softmax", "single_pos"])
@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
def test_zsg_loss_variants_match_jax(variant, weights):
    anchors, att, bbx, gt = _loss_setup(np.random.default_rng(4))
    w = WEIGHTS[weights]
    variant = dict(variant)
    use_multi = variant.pop("use_multi")
    labels, reg = t_anchors.match_and_encode(_t(anchors), _t(gt), use_multi=use_multi)
    got = t_losses.zsg_loss(_t(att), _t(bbx), labels, reg, lamb_reg=1.5,
                            sample_weight=None if w is None else _t(w), **variant)
    j_labels, j_reg = j_anchors.match_and_encode(jnp.asarray(anchors), jnp.asarray(gt),
                                                 use_multi=use_multi)
    want = j_losses.zsg_loss(jnp.asarray(att), jnp.asarray(bbx), j_labels, j_reg, lamb_reg=1.5,
                             sample_weight=None if w is None else jnp.asarray(w), **variant)
    for k in ("total", "cls_ls", "box_ls", "num_pos"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, err_msg=k)


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
def test_fused_loss_matches_jax_pallas_interpret(weights):
    anchors, att, bbx, gt = _loss_setup(np.random.default_rng(5))
    w = WEIGHTS[weights]
    with pltpu.force_tpu_interpret_mode():
        want = j_fused(
            jnp.asarray(att), jnp.asarray(bbx), jnp.asarray(j_pack(anchors)), jnp.asarray(gt),
            num_anchors=anchors.shape[0], lamb_reg=1.5,
            sample_weight=None if w is None else jnp.asarray(w),
        )
    packed = t_fused.pack_anchors(anchors, "cpu")
    got = t_fused.zsg_loss_fused(_t(att), _t(bbx), packed, _t(gt), lamb_reg=1.5,
                                 sample_weight=None if w is None else _t(w))
    for k in ("total", "cls_ls", "box_ls", "num_pos"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, err_msg=k)
    # The plain version's raw sums, against the oracle's normalized terms.
    ones = np.ones(len(gt), np.float32) if w is None else w
    launches = t_fused.fused_match_loss.launches
    sums = t_fused.fused_match_loss(_t(att), _t(bbx), *packed, _t(gt), _t(ones))
    assert t_fused.fused_match_loss.launches == launches  # the CPU never launches the kernel
    num_pos = max(float(sums[2]), 1.0)
    np.testing.assert_allclose(float(sums[0]) / num_pos, float(want["cls_ls"]), rtol=2e-5)
    np.testing.assert_allclose(float(sums[1]) / num_pos, float(want["box_ls"]), rtol=2e-5)


def test_fused_loss_force_best_tie_break():
    """A zero-extent gt has IoU 0 at every anchor: the first anchor is the
    promoted positive, as with jnp.argmax."""
    anchors, att, bbx, _ = _loss_setup(np.random.default_rng(6), b=1)
    gt = np.array([[0.3, 0.3, 0.3, 0.3]], np.float32)
    packed = t_fused.pack_anchors(anchors, "cpu")
    sums = t_fused.fused_match_loss(_t(att), _t(bbx), *packed, _t(gt), torch.ones(1))
    assert float(sums[2]) == 1.0
    j_labels, _ = j_anchors.match_and_encode(jnp.asarray(anchors), jnp.asarray(gt))
    assert np.flatnonzero(np.asarray(j_labels)[0] == 1).tolist() == [0]


@pytest.mark.parametrize("a", [2051, 5003], ids=["A2051", "A5003"])
def test_fused_loss_promotion_and_ties_match_jax(a):
    """Rows whose positives hang on the argmax anchor (a best anchor under
    match_thr in a later eighth of the anchors, equal maxima in two eighths,
    a zero-extent box, zero-weight rows; zsgnet_tpu_torch.tools.loss_cases.k1_promotion_case,
    which the CUDA tests of K1 share): the plain version finds the anchors
    the case was built to have and agrees with the JAX Pallas kernel in
    interpret mode (num_pos exact, the sums to rtol 1e-5: float32 sums in
    another order)."""
    from zsgnet_tpu_torch.tools.loss_cases import k1_promotion_case

    case = k1_promotion_case(8, a, seed=a)
    anchors, att, bbx, gt, w = (case[k] for k in ("anchors_cthw", "att", "bbx", "gt", "w"))
    packed = t_fused.pack_anchors(anchors, "cpu")
    iou = t_boxes.iou_pairwise(_t(gt)[:, None, :], packed[0])[:, 0, :]
    assert iou.argmax(dim=-1).tolist() == case["best"].tolist()
    assert float(iou[0].max()) < 0.5 and float(iou[1].max()) < 0.5  # positives by promotion only
    with pltpu.force_tpu_interpret_mode():
        want = j_fused(jnp.asarray(att), jnp.asarray(bbx), jnp.asarray(j_pack(anchors)), jnp.asarray(gt),
                       num_anchors=a, sample_weight=jnp.asarray(w))
    sums = t_fused.fused_match_loss(_t(att), _t(bbx), *packed, _t(gt), _t(w))
    assert float(sums[2]) == float(want["num_pos"])
    # Rows 0, 1 and 2 have exactly one positive, the promoted anchor; row 3's planted anchor is over match_thr.
    per_row = [float(t_fused.fused_match_loss(_t(att[r:r + 1]), _t(bbx[r:r + 1]), *packed, _t(gt[r:r + 1]),
                                              torch.ones(1))[2]) for r in range(4)]
    assert per_row[:3] == [1.0, 1.0, 1.0] and per_row[3] >= 1.0
    num_pos = max(float(sums[2]), 1.0)
    np.testing.assert_allclose(float(sums[0]) / num_pos, float(want["cls_ls"]), rtol=1e-5)
    np.testing.assert_allclose(float(sums[1]) / num_pos, float(want["box_ls"]), rtol=1e-5)


def test_fused_loss_zero_weight_rows_add_nothing():
    """Rows of weight 0 leave the three sums untouched (the case's rows 4, 9, ...)."""
    from zsgnet_tpu_torch.tools.loss_cases import k1_promotion_case

    case = k1_promotion_case(10, 2051, seed=1)
    packed = t_fused.pack_anchors(case["anchors_cthw"], "cpu")
    keep = case["w"] > 0
    assert (~keep).sum() == 2
    full = t_fused.fused_match_loss(_t(case["att"]), _t(case["bbx"]), *packed, _t(case["gt"]), _t(case["w"]))
    kept = t_fused.fused_match_loss(_t(case["att"][keep]), _t(case["bbx"][keep]), *packed,
                                    _t(case["gt"][keep]), _t(case["w"][keep]))
    assert float(full[2]) == float(kept[2])
    np.testing.assert_allclose(full.numpy(), kept.numpy(), rtol=1e-6)  # float32 sums over fewer rows
