"""Kernel tests that need an NVIDIA GPU (Hopper, sm_90a) and nvcc.

Marked ``cuda``; without a CUDA device each test skips with that reason.
On the GPU machine run them with ``python -m pytest tests/test_torch_cuda.py``.
The kernel is held against its plain PyTorch version on the same card:
``num_pos`` exact, the two sums to rtol 1e-4 (float32 sums in another
order).
"""

import numpy as np
import pytest
import torch

from zsgnet_tpu_torch.ops import anchors as anchor_ops
from zsgnet_tpu_torch.ops.cuda import fused_loss as fl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _inputs(dev, b, img=(300, 300), seed=0):
    anchors = anchor_ops.create_anchors((1.0, 1.26, 1.59), (0.5, 1.0, 2.0),
                                        anchor_ops.feature_map_sizes(img))
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
