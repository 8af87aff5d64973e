"""ResNet-50 backbone — torch port of ``zsgnet_tpu/models/resnet.py``.

torchvision's layout and parameter names (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1,2,3}``/``bn{1,2,3}``/``downsample.{0,1}``),
bottleneck v1.5 (stride in the 3×3), BatchNorm with eps 1e-5 that uses its
running statistics in eval mode. Returns the C3/C4/C5 taps (512/1024/2048
channels, strides 8/16/32), NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

Tensor = torch.Tensor


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch),
            )

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + identity)


class ResNet50(nn.Module):
    """(B, 3, H, W) normalized image → (C3, C4, C5)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for stage_i, (n_blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            blocks = []
            for block_i in range(n_blocks):
                stride = 2 if (block_i == 0 and stage_i > 0) else 1
                blocks.append(Bottleneck(in_ch, width, stride))
                in_ch = width * Bottleneck.expansion
            setattr(self, f"layer{stage_i + 1}", nn.Sequential(*blocks))

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        c2 = self.layer1(x)
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5
