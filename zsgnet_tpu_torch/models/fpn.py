"""Feature Pyramid Network P3–P7 — torch port of ``zsgnet_tpu/models/fpn.py``.

1×1 laterals, nearest top-down upsample + add, 3×3 smoothing; P6 is a
stride-2 3×3 conv on C5 and P7 a stride-2 3×3 conv on relu(P6). Module
names follow the reference lineage that the JAX converter's
``FPN_NAME_MAP`` reads (``latlayer1..3``, ``toplayer0..2``, ``conv6``,
``conv7``). ``F.interpolate(mode="nearest")`` picks source pixel
floor(dst·in/out), which the JAX ``upsample_nearest_torch`` reproduces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


class FPN(nn.Module):
    """(C3, C4, C5) → (P3, P4, P5, P6, P7), all ``out_ch`` channels."""

    def __init__(self, out_ch: int = 256):
        super().__init__()
        # Inputs are ResNet-50's C3/C4/C5: 512/1024/2048 channels.
        self.latlayer1 = nn.Conv2d(2048, out_ch, 1)  # lat5
        self.latlayer2 = nn.Conv2d(1024, out_ch, 1)  # lat4
        self.latlayer3 = nn.Conv2d(512, out_ch, 1)  # lat3
        self.toplayer0 = nn.Conv2d(out_ch, out_ch, 3, padding=1)  # smooth5
        self.toplayer1 = nn.Conv2d(out_ch, out_ch, 3, padding=1)  # smooth4
        self.toplayer2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)  # smooth3
        self.conv6 = nn.Conv2d(2048, out_ch, 3, stride=2, padding=1)  # p6
        self.conv7 = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=1)  # p7

    def forward(self, c3: Tensor, c4: Tensor, c5: Tensor) -> tuple[Tensor, ...]:
        p5 = self.latlayer1(c5)
        p4 = self.latlayer2(c4) + F.interpolate(p5, size=c4.shape[-2:], mode="nearest")
        p3 = self.latlayer3(c3) + F.interpolate(p4, size=c3.shape[-2:], mode="nearest")
        p6 = self.conv6(c5)
        p7 = self.conv7(F.relu(p6))
        return self.toplayer2(p3), self.toplayer1(p4), self.toplayer0(p5), p6, p7
