"""ResNet-50 backbone — torch port of ``zsgnet_tpu/models/resnet.py``.

torchvision's layout and parameter names (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1,2,3}``/``bn{1,2,3}``/``downsample.{0,1}``),
bottleneck v1.5 (stride in the 3×3), BatchNorm with eps 1e-5 and the JAX
package's momentum 0.9 (torch's 0.1) that normalizes with the batch's
moments in training and with its running statistics in eval mode. Returns
the C3/C4/C5 taps (512/1024/2048 channels, strides 8/16/32), NCHW.

``ResNet50(remat=True)`` recomputes each bottleneck's activations in the
backward pass instead of keeping them (``torch.utils.checkpoint``, the JAX
package's ``nn.remat`` per block), in training mode only. The recomputed
forward leaves the BatchNorm statistics alone: the momentum update is
applied once per step, as flax's side-effect-free remat does.

``quant_mode`` builds every convolution through ``models.quant.conv_for``
(the JAX package quantizes the same ones: the stem, each bottleneck's three
and its downsample).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from zsgnet_tpu_torch.models.quant import conv_for

Tensor = torch.Tensor


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode update of ``running_var`` uses
    the biased batch variance, as flax's ``nn.BatchNorm`` does; torch's uses
    the unbiased one, n/(n−1) larger for n values per channel.

    The forward stays torch's ``batch_norm`` (cuDNN on the card), which
    updates a copy of ``running_var``: with m the momentum and v_u the
    unbiased variance it writes (1−m)·old + m·v_u there, and
    (1−m)·old + m·v_u·(n−1)/n, what flax writes, goes into ``running_var``.
    (The op's autograd node holds the copy, so the buffer itself may
    change in place.) Every ``bn_variance`` mode of the config trains with
    this exact variance: ``shifted`` is algebraically equal to it, and
    ``fast``/``shifted16`` differ from it only by rounding in the JAX
    package.

    While ``frozen_stats`` is set (the recomputation under remat) the
    training-mode forward normalizes with the batch's moments as usual and
    updates nothing."""

    frozen_stats = False

    def forward(self, x: Tensor) -> Tensor:
        if not self.training:
            return super().forward(x)
        if self.frozen_stats:
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        self.num_batches_tracked.add_(1)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum
        with torch.no_grad():
            delta = (var - keep * self.running_var) * ((n - 1) / n)
            self.running_var.mul_(keep).add_(delta)
        return y


@contextlib.contextmanager
def frozen_bn_stats(module: nn.Module) -> Iterator[None]:
    """The BatchNorm layers of ``module`` update no statistics inside."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen_stats = False


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1, quant_mode: str = "off"):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = conv_for(quant_mode, in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = conv_for(quant_mode, width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = conv_for(quant_mode, width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                conv_for(quant_mode, in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm2d(out_ch),
            )

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNet50(nn.Module):
    """(B, 3, H, W) normalized image → (C3, C4, C5)."""

    def __init__(self, remat: bool = False, quant_mode: str = "off"):
        super().__init__()
        self.remat = remat
        self.conv1 = conv_for(quant_mode, 3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for stage_i, (n_blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            blocks = []
            for block_i in range(n_blocks):
                stride = 2 if (block_i == 0 and stage_i > 0) else 1
                blocks.append(Bottleneck(in_ch, width, stride, quant_mode))
                in_ch = width * Bottleneck.expansion
            setattr(self, f"layer{stage_i + 1}", nn.Sequential(*blocks))

    def _stage(self, stage: nn.Sequential, x: Tensor) -> Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return stage(x)
        for block in stage:
            x = checkpoint(block, x, use_reentrant=False,
                           context_fn=lambda b=block: (contextlib.nullcontext(), frozen_bn_stats(b)))
        return x

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        c2 = self._stage(self.layer1, x)
        c3 = self._stage(self.layer2, c2)
        c4 = self._stage(self.layer3, c3)
        c5 = self._stage(self.layer4, c4)
        return c3, c4, c5
