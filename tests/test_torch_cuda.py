"""Kernel tests that need an NVIDIA GPU (Hopper, sm_90a) and nvcc.

Marked ``cuda``; without a CUDA device each test skips with that reason.
On the GPU machine run them with ``python -m pytest tests/test_torch_cuda.py``.
Each kernel is held against its plain PyTorch version on the same card.
K1: ``num_pos`` exact, the two sums to rtol 1e-4 (float32 sums in another
order), the argmax anchors exact, one kernel launch per call,
bit-identical on repeat. K2: atol 1e-6 on gradients of order 1
(elementwise float32; exp and pow round differently from torch's), every
kernel of its source, one launch per call, bit-identical on repeat. K1 and
K2 on non-finite logits and deltas: NaN where the plain version has NaN,
the same tolerances elsewhere (the plain version is held against the JAX
kernel in tests/test_torch_loss_nonfinite.py). K3:
atol/rtol 2e-2 (below), bit-identical on repeat, for the Hopper (wgmma)
kernel at ResNet-50 layer1 widths and the mma.sync kernel elsewhere, and
the two against each other.
"""

import numpy as np
import pytest
import torch

from zsgnet_tpu_torch.models.ssd_vgg import ssd_feature_map_sizes
from zsgnet_tpu_torch.ops import anchors as anchor_ops
from zsgnet_tpu_torch.ops.cuda import fused_bottleneck as fb
from zsgnet_tpu_torch.ops.cuda import fused_loss as fl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _inputs(dev, b, img=(300, 300), seed=0, sizes=None):
    """Seeded K1/K2 inputs over the retina pyramid of ``img`` (or the
    pyramid of ``sizes``); row 0's gt has zero extent, so its IoU ties at 0
    over every anchor."""
    anchors = anchor_ops.create_anchors((1.0, 1.26, 1.59), (0.5, 1.0, 2.0),
                                        sizes or anchor_ops.feature_map_sizes(img))
    rng = np.random.default_rng(seed)
    a = anchors.shape[0]
    lo = rng.uniform(-1, 0.6, size=(b, 2))
    gt = np.concatenate([lo, lo + rng.uniform(0.05, 0.8, size=(b, 2))], axis=1)
    gt[0] = (0.2, 0.2, 0.2, 0.2)  # zero extent: IoU ties at 0 everywhere
    tensors = [
        rng.normal(size=(b, a)) * 2, rng.normal(size=(b, a, 4)), gt,
        (rng.uniform(size=b) > 0.3),
    ]
    att, bbx, gt, w = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in tensors)
    return att, bbx, fl.pack_anchors(anchors, dev), gt, w


@pytest.mark.parametrize("b,img", [(16, (300, 300)), (3, (64, 64)), (1, (96, 160))])
def test_kernel_matches_plain_version(cuda, b, img):
    att, bbx, anc, gt, w = _inputs(cuda, b, img)
    launches = fl.fused_match_loss.launches
    got = fl.fused_match_loss(att, bbx, *anc, gt, w)
    want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w)
    torch.cuda.synchronize()
    assert fl.fused_match_loss.launches == launches + 1
    assert float(got[2]) == float(want[2])
    torch.testing.assert_close(got[:2], want[:2], rtol=1e-4, atol=0.0)


def test_kernel_is_deterministic(cuda):
    att, bbx, anc, gt, w = _inputs(cuda, 16)
    first = fl.fused_match_loss(att, bbx, *anc, gt, w)
    for _ in range(3):
        assert torch.equal(fl.fused_match_loss(att, bbx, *anc, gt, w), first)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    att, bbx, anc, gt, w = _inputs(cuda, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_match_loss(att, bbx.transpose(0, 1).contiguous().transpose(0, 1), *anc, gt, w)
    with pytest.raises(TypeError, match="dtype"):
        fl.fused_match_loss(att.double(), bbx, *anc, gt, w)
    with pytest.raises(ValueError, match="shape"):
        fl.fused_match_loss(att[:, :-1].contiguous(), bbx, *anc, gt, w)


# The new shapes of the model variants: grouped training (24 images × 5
# phrases = 120 rows at A = 17451) and SSD-VGG at 300² (A = 17460).
VARIANT_SHAPES = {"grouped_b120": (120, None), "ssd_b16_a17460": (16, ssd_feature_map_sizes((300, 300)))}


@pytest.mark.parametrize("case", list(VARIANT_SHAPES))
def test_kernels_match_plain_versions_at_the_variant_shapes(cuda, case):
    b, sizes = VARIANT_SHAPES[case]
    att, bbx, anc, gt, w = _inputs(cuda, b, seed=5, sizes=sizes)
    assert att.shape[1] == (17460 if sizes else 17451)
    launches = (fl.fused_match_loss.launches, fl.fused_match_loss_backward.launches)
    got, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w)
    assert torch.equal(best, _best_plain(anc, gt))
    assert float(got[2]) == float(want[2])
    torch.testing.assert_close(got[:2], want[:2], rtol=1e-4, atol=0.0)
    grad = torch.tensor([0.05, -0.7, 3.0], device=cuda)
    dgot = fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
    dwant = fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad)
    torch.cuda.synchronize()
    for g, x in zip(dgot, dwant):
        torch.testing.assert_close(g, x, atol=1e-6, rtol=0)
    assert (fl.fused_match_loss.launches, fl.fused_match_loss_backward.launches) == (launches[0], launches[1] + 1)


def _best_plain(anc, gt):
    from zsgnet_tpu_torch.ops import boxes as box_ops

    return box_ops.iou_pairwise(gt[:, None, :], anc[0])[:, 0, :].argmax(dim=-1).int()


@pytest.mark.parametrize("b,img", [(16, (300, 300)), (3, (64, 64)), (1, (96, 160))])
def test_backward_kernel_matches_plain_version(cuda, b, img):
    att, bbx, anc, gt, w = _inputs(cuda, b, img, seed=1)
    _, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    assert torch.equal(best, _best_plain(anc, gt))
    assert int(best[0]) == 0  # the zero-extent row ties at IoU 0: the first anchor
    grad = torch.tensor([0.05, -0.7, 3.0], device=cuda)
    launches = fl.fused_match_loss_backward.launches
    got = fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
    want = fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad)
    torch.cuda.synchronize()
    assert fl.fused_match_loss_backward.launches == launches + 1
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, x, atol=1e-6, rtol=0)


def test_function_gradients_match_autograd_of_plain_forward(cuda):
    att, bbx, anc, gt, w = _inputs(cuda, 16, seed=2)
    a1, b1 = att.clone().requires_grad_(), bbx.clone().requires_grad_()
    a2, b2 = att.clone().requires_grad_(), bbx.clone().requires_grad_()
    fwd, bwd = fl.fused_match_loss.launches, fl.fused_match_loss_backward.launches
    ls = fl.zsg_loss_fused(a1, b1, anc, gt, lamb_reg=1.5, sample_weight=w)
    ls["total"].backward()
    assert (fl.fused_match_loss.launches, fl.fused_match_loss_backward.launches) == (fwd + 1, bwd + 1)
    sums = fl.fused_match_loss_reference(a2, b2, *anc, gt, w)
    n = sums[2].clamp(min=1.0)
    (sums[0] / n + 1.5 * sums[1] / n).backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(a1.grad, a2.grad, atol=1e-6, rtol=0)
    torch.testing.assert_close(b1.grad, b2.grad, atol=1e-6, rtol=0)


def test_backward_kernel_is_deterministic(cuda):
    att, bbx, anc, gt, w = _inputs(cuda, 16, seed=3)
    _, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    grad = torch.tensor([0.1, 0.2, 0.0], device=cuda)
    first = fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
    for _ in range(3):
        again = fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
        assert all(torch.equal(x, y) for x, y in zip(again, first))


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    att, bbx, anc, gt, w = _inputs(cuda, 4)
    _, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    grad = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_match_loss_backward(att.t().contiguous().t(), bbx, *anc, gt, w, best, grad)
    with pytest.raises(TypeError, match="dtype"):
        fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best.long(), grad)
    with pytest.raises(ValueError, match="shape"):
        fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best[:-1].contiguous(), grad)
    with pytest.raises(ValueError, match="shape"):
        fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad[:2])


def _case(dev, b, a, seed=0):
    """zsgnet_tpu_torch.tools.loss_cases.k1_promotion_case on the card → (att, bbx, anchors, gt, w, best)."""
    from zsgnet_tpu_torch.tools.loss_cases import k1_promotion_case

    c = k1_promotion_case(b, a, seed)
    att, bbx, gt, w = (torch.from_numpy(c[k]).to(dev) for k in ("att", "bbx", "gt", "w"))
    return att, bbx, fl.pack_anchors(c["anchors_cthw"], dev), gt, w, torch.from_numpy(c["best"]).int().to(dev)


# B = 1 and B = 17; A not a multiple of 8 x 512 and A = 8 x 512; rows whose
# best anchor is under match_thr in a later share of the row's cluster, equal
# maxima in two shares, zero-extent boxes and zero-weight rows are in every case.
@pytest.mark.parametrize("b,a", [(1, 5003), (4, 4096), (17, 5003), (16, 17451), (36, 811)])
def test_kernel_promotes_the_first_argmax_anchor(cuda, b, a):
    att, bbx, anc, gt, w, best = _case(cuda, b, a, seed=b)
    got, got_best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w)
    torch.cuda.synchronize()
    assert torch.equal(got_best, best)  # the lower index of a tie, whichever share holds it
    assert float(got[2]) == float(want[2])
    torch.testing.assert_close(got[:2], want[:2], rtol=1e-4, atol=0.0)
    # Row 0: one positive, under match_thr, outside the first share.
    share = -(-a // 8)
    assert int(best[0]) >= share
    row0 = fl.fused_match_loss(att[:1], bbx[:1], *anc, gt[:1], torch.ones(1, device=cuda))
    assert float(row0[2]) == 1.0


def test_kernel_zero_weight_rows_add_nothing(cuda):
    att, bbx, anc, gt, w, _ = _case(cuda, 10, 5003)
    keep = w > 0
    assert int((~keep).sum()) == 2
    full = fl.fused_match_loss(att, bbx, *anc, gt, w)
    kept = fl.fused_match_loss(att[keep].contiguous(), bbx[keep].contiguous(), *anc,
                               gt[keep].contiguous(), w[keep].contiguous())
    assert float(full[2]) == float(kept[2])
    torch.testing.assert_close(full, kept, rtol=1e-6, atol=0.0)  # the same terms, summed over fewer rows


def test_kernel_two_calls_in_a_row_give_identical_bits(cuda):
    """The ticket that picks the cluster summing the rows returns to 0 after
    every call; a stale one would leave ``out`` unwritten or sum too early."""
    att, bbx, anc, gt, w, _ = _case(cuda, 17, 5003)
    first = fl.fused_match_loss(att, bbx, *anc, gt, w).clone()
    second = fl.fused_match_loss(att, bbx, *anc, gt, w).clone()
    other = fl.fused_match_loss(att[:3].contiguous(), bbx[:3].contiguous(), *anc, gt[:3].contiguous(),
                                w[:3].contiguous())  # another batch size in between
    third = fl.fused_match_loss(att, bbx, *anc, gt, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)
    assert torch.isfinite(other).all()
    ticket = fl._ticket(att.device, torch.cuda.current_stream().cuda_stream)
    assert int(ticket) == 0


def test_kernel_long_share_path(cuda):
    """A 600² pyramid has 67995 anchors: a share of 8500, over the 8192 IoUs a
    block keeps, so the second pass computes them again."""
    att, bbx, anc, gt, w = _inputs(cuda, 2, (600, 600), seed=4)
    assert att.shape[1] > 8 * 8192
    got, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w)
    assert torch.equal(best, _best_plain(anc, gt))
    assert float(got[2]) == float(want[2])
    torch.testing.assert_close(got[:2], want[:2], rtol=1e-4, atol=0.0)
    assert torch.equal(fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)[0], got)


def test_kernel_is_one_launch_per_call(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    att, bbx, anc, gt, w = _inputs(cuda, 16)
    fl.fused_match_loss(att, bbx, *anc, gt, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fl.fused_match_loss(att, bbx, *anc, gt, w)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and kernels[0][1] == 5, kernels


# B = 1, 16 and 33 rows of the promotion case (promoted argmax anchors, ties
# across the row, zero-extent boxes, zero weights) at anchor counts that no
# tile of 256 anchors or vector width divides.
@pytest.mark.parametrize("b", [1, 16, 33])
@pytest.mark.parametrize("a", [2051, 17451])
def test_backward_kernels_match_plain_version_and_each_other(cuda, b, a):
    att, bbx, anc, gt, w, best = _case(cuda, b, a, seed=a + b)
    grad = torch.tensor([0.3, -1.1, 0.0], device=cuda)
    want = fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad)
    launches = fl.fused_match_loss_backward.launches
    got = fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
    assert fl.fused_match_loss_backward.launches == launches + 1
    outs = {v: fl.launch_bwd_variant(v, att, bbx, *anc, gt, w, best, grad) for v in fl.BWD_VARIANTS}
    torch.cuda.synchronize()
    assert fl.fused_match_loss_backward.launches == launches + 1  # named launches count none
    assert all(torch.equal(x, y) for x, y in zip(outs[fl.BWD_KERNEL], got))
    for v, out in outs.items():
        for g, x, y in zip(out, want, got):
            torch.testing.assert_close(g, x, atol=1e-6, rtol=0, msg=lambda m: f"{v} vs plain: {m}")
            torch.testing.assert_close(g, y, atol=1e-6, rtol=0, msg=lambda m: f"{v} vs {fl.BWD_KERNEL}: {m}")
    pos = fl._labels(anc[0], gt, 0.5, 0.4)[0]
    assert bool((got[1][~pos] == 0).all()) and bool((got[1][pos] != 0).any())


def test_backward_kernels_take_powf_for_other_gamma(cuda):
    att, bbx, anc, gt, w, best = _case(cuda, 16, 2051, seed=5)
    grad = torch.tensor([0.7, 0.4, 0.0], device=cuda)
    hp = dict(match_thr=0.5, neg_thr=0.4, alpha=0.5, gamma=1.5)
    want = fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad, **hp)
    for v in fl.BWD_VARIANTS:
        got = fl.launch_bwd_variant(v, att, bbx, *anc, gt, w, best, grad, **hp)
        for g, x in zip(got, want):
            torch.testing.assert_close(g, x, atol=1e-6, rtol=0)


def test_backward_kernels_are_deterministic(cuda):
    att, bbx, anc, gt, w, best = _case(cuda, 33, 17451, seed=6)
    grad = torch.tensor([0.1, 0.2, 0.0], device=cuda)
    for v in fl.BWD_VARIANTS:
        first = fl.launch_bwd_variant(v, att, bbx, *anc, gt, w, best, grad)
        again = fl.launch_bwd_variant(v, att, bbx, *anc, gt, w, best, grad)
        assert all(torch.equal(x, y) for x, y in zip(again, first)), v


def test_backward_kernel_is_one_launch_per_call(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    att, bbx, anc, gt, w = _inputs(cuda, 16)
    _, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    grad = torch.tensor([0.1, 0.2, 0.0], device=cuda)
    fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and kernels[0][1] == 5 and "match_loss_grads_pos_only" in kernels[0][0], kernels


NONFINITE = [(v, x, lab, wt) for v in ("nan", "inf", "-inf") for x in ("att", "bbx")
             for lab in ("positive", "promoted", "ignored", "negative") for wt in (1.0, 0.0)]


@pytest.mark.parametrize("value,where,label,weight", NONFINITE,
                         ids=[f"{v}-{x}-{lab}-w{int(wt)}" for v, x, lab, wt in NONFINITE])
def test_kernels_on_nonfinite_inputs_match_plain_version(cuda, value, where, label, weight):
    """K1's sums and K2's gradients where a logit or a delta is NaN or
    infinite: non-finite exactly where the plain version is (a non-finite
    delta at a non-positive anchor makes K1's box sum NaN, K2's dbbx there 0)."""
    from zsgnet_tpu_torch.tools.loss_cases import nonfinite_case

    c = nonfinite_case(float(value), where, label, weight)
    att, bbx, gt, w = (torch.from_numpy(c[k]).to(cuda) for k in ("att", "bbx", "gt", "w"))
    anc = fl.pack_anchors(c["anchors_cthw"], cuda)
    sums, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w)
    np.testing.assert_allclose(sums.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=0, equal_nan=True)
    grad = torch.tensor([0.4, 1.3, 0.0], device=cuda)
    got = fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
    want = fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), x.cpu().numpy(), atol=1e-6, rtol=0, equal_nan=True)


# ------------------------------------------------------------------ K3
# K3 against its plain version in the working type bf16 (and float32 at the
# small shape): atol/rtol 2e-2, the JAX test's tolerance (bf16 rounding of
# h1/h2 may flip on float32 sums taken in another order).

K3_SHAPES = {
    "layer1-identity": (16, 75, 75, 256, 64, 256, False),
    "layer1-projection": (16, 75, 75, 64, 64, 256, True),
    "odd-identity": (3, 11, 9, 16, 8, 16, False),
    "odd-projection": (3, 11, 9, 16, 8, 32, True),
    # layer1 widths: ragged tiles on both axes with B = 1, sides under a tile, one pixel
    "ragged-identity": (1, 13, 21, 256, 64, 256, False),
    "ragged-projection": (2, 9, 17, 64, 64, 256, True),
    "small-identity": (1, 5, 3, 256, 64, 256, False),
    "small-projection": (3, 3, 20, 64, 64, 256, True),
    "pixel-identity": (2, 1, 1, 256, 64, 256, False),
    # widths the Hopper kernel takes besides layer1's, and some it leaves to mma.sync
    "narrow64-identity": (2, 10, 19, 64, 64, 64, False),
    "wide128-identity": (2, 10, 19, 128, 64, 128, False),
    "wide192-identity": (1, 17, 33, 192, 64, 192, False),
    "projection-to-128": (2, 10, 19, 64, 64, 128, True),
    "cmid32-identity": (2, 10, 19, 64, 32, 64, False),
    "projection-from-128": (2, 10, 19, 128, 64, 128, True),
}
K3_KERNEL = {name: "mma" for name in K3_SHAPES} | {
    name: "wgmma8x16" for name in (
        "layer1-identity", "layer1-projection", "ragged-identity", "ragged-projection", "small-identity",
        "small-projection", "pixel-identity", "narrow64-identity", "wide128-identity", "wide192-identity",
        "projection-to-128")}


def _k3_inputs(dev, shape, dtype=torch.bfloat16, seed=0):
    from zsgnet_tpu_torch.tools.bench_bottleneck import random_args

    b, h, w, cin, cmid, cout, proj = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, h, w, cin)).astype(np.float32)).to(dev).to(dtype)
    return x, random_args(rng, cin, cmid, cout, proj, dev)


@pytest.mark.parametrize("name", list(K3_SHAPES))
def test_bottleneck_kernel_matches_plain_version(cuda, name):
    x, args = _k3_inputs(cuda, K3_SHAPES[name])
    launches = fb.fused_bottleneck_infer.launches
    got = fb.fused_bottleneck_infer(x, **args)
    want = fb.bottleneck_infer_reference(x, **args)
    torch.cuda.synchronize()
    assert fb.fused_bottleneck_infer.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    b, h, w, cin, cmid, cout, proj = K3_SHAPES[name]
    assert fb.kernel_for(cin, cmid, cout, proj) == K3_KERNEL[name]  # chosen by the widths alone


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "projection"])
def test_bottleneck_kernel_in_float32(cuda, proj):
    shape = K3_SHAPES["odd-projection" if proj else "odd-identity"]
    x, args = _k3_inputs(cuda, shape, torch.float32, seed=1)
    got = fb.fused_bottleneck_infer(x, **args)
    want = fb.bottleneck_infer_reference(x, **args)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", ["layer1-identity", "layer1-projection", "ragged-identity"])
def test_bottleneck_kernel_is_deterministic(cuda, name):
    x, args = _k3_inputs(cuda, K3_SHAPES[name], seed=2)
    first = fb.fused_bottleneck_infer(x, **args)
    for _ in range(2):
        assert torch.equal(fb.fused_bottleneck_infer(x, **args), first)


@pytest.mark.parametrize("name", ["ragged-identity", "ragged-projection", "small-identity"])
def test_bottleneck_hopper_kernel_in_float32(cuda, name):
    # float32 x at layer1 width: converted on the way into shared memory, the
    # residual and the output in float32.
    x, args = _k3_inputs(cuda, K3_SHAPES[name], torch.float32, seed=3)
    got = fb.fused_bottleneck_infer(x, **args)
    want = fb.bottleneck_infer_reference(x, **args)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert torch.equal(fb.fused_bottleneck_infer(x, **args), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["layer1-identity", "layer1-projection", "ragged-identity",
                                  "ragged-projection"])
def test_bottleneck_kernels_agree_at_layer1_width(cuda, name, dtype):
    """The source's kernels, forced one after the other on the same input:
    the mma.sync kernel and the Hopper kernel with 8 x 8 and 8 x 16 tiles agree
    within the bf16 tolerance (their float32 sums run in other orders)."""
    x, args = _k3_inputs(cuda, K3_SHAPES[name], dtype, seed=4)
    launches = fb.fused_bottleneck_infer.launches
    outs = {v: fb.launch_variant(v, x, **args) for v in ("mma", "wgmma8x8", "wgmma8x16")}
    torch.cuda.synchronize()
    assert fb.fused_bottleneck_infer.launches == launches  # counted only through fused_bottleneck_infer
    for v in ("wgmma8x8", "wgmma8x16"):
        torch.testing.assert_close(outs[v].float(), outs["mma"].float(), atol=2e-2, rtol=2e-2)


def test_bottleneck_forced_kernel_refuses_other_widths(cuda):
    x, args = _k3_inputs(cuda, K3_SHAPES["odd-identity"])
    with pytest.raises(RuntimeError, match="CUDA error"):
        fb.launch_variant("wgmma8x16", x, **args)


def test_bottleneck_weights_are_packed_once(cuda):
    """The Hopper kernel's packed weights are made by one launch the first
    time a set of weights is seen, and again after an in-place update."""
    x, args = _k3_inputs(cuda, K3_SHAPES["ragged-identity"], seed=5)
    packs = fb.fused_bottleneck_infer.pack_launches
    first = fb.fused_bottleneck_infer(x, **args)
    fb.fused_bottleneck_infer(x, **args)
    assert fb.fused_bottleneck_infer.pack_launches == packs + 1
    args["w3"].mul_(2.0)
    changed = fb.fused_bottleneck_infer(x, **args)
    assert fb.fused_bottleneck_infer.pack_launches == packs + 2
    torch.testing.assert_close(changed.float(), fb.bottleneck_infer_reference(x, **args).float(),
                               atol=2e-2, rtol=2e-2)
    assert not torch.equal(changed, first)


def test_bottleneck_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, args = _k3_inputs(cuda, K3_SHAPES["odd-identity"])
    with pytest.raises(ValueError, match="multiples of 16"):
        fb.fused_bottleneck_infer(x[..., :8].contiguous(), **{**args, "w1": args["w1"][:8].contiguous(),
                                                             "w3": args["w3"][:, :8].contiguous(),
                                                             "s3": args["s3"][:8], "b3": args["b3"][:8]})
    with pytest.raises(ValueError, match="contiguous"):
        fb.fused_bottleneck_infer(x.transpose(1, 2).contiguous().transpose(1, 2), **args)
    with pytest.raises(TypeError, match="dtype"):
        fb.fused_bottleneck_infer(x.half(), **args)
    with pytest.raises(ValueError, match="is on"):
        fb.fused_bottleneck_infer(x, **{**args, "w1": args["w1"].cpu()})
    wide, wide_args = _k3_inputs(cuda, K3_SHAPES["ragged-projection"])
    flat = torch.zeros(wide.numel() + 8, dtype=wide.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):  # 2 bytes past a boundary: no tensor map
        fb.fused_bottleneck_infer(flat[1:wide.numel() + 1].view(wide.shape), **wide_args)
