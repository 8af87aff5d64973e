"""Feature Pyramid Network P3–P7 — torch port of ``zsgnet_tpu/models/fpn.py``.

1×1 laterals, nearest top-down upsample + add, 3×3 smoothing; P6 is a
stride-2 3×3 conv on C5 and P7 a stride-2 3×3 conv on relu(P6). Module
names follow the reference lineage that the JAX converter's
``FPN_NAME_MAP`` reads (``latlayer1..3``, ``toplayer0..2``, ``conv6``,
``conv7``). ``F.interpolate(mode="nearest")`` picks source pixel
floor(dst·in/out), which the JAX ``upsample_nearest_torch`` reproduces.
``quant_mode`` builds all eight convolutions through
``models.quant.conv_for``.

``forward(c3, c4, c5, spatial, shard_flags)`` takes the spatial backbone's
taps with their flags (``parallel.halo``), as the JAX ``FPN`` does: a
sharded 3×3 conv exchanges halos, or reshards first where ``halo_plan``
rejects its local height; a sharded lateral meeting a resharded one is
resharded first; P6 takes C5's flag, not P5's; and every output is
resharded before it is returned. The top-down upsample needs no halo when
both sides are sharded: their local heights divide as the global ones do,
so the local nearest-neighbour index map is the global one.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from zsgnet_tpu_torch.models.quant import conv_for
from zsgnet_tpu_torch.parallel.halo import conv_rows, halo_plan

Tensor = torch.Tensor


class FPN(nn.Module):
    """(C3, C4, C5) → (P3, P4, P5, P6, P7), all ``out_ch`` channels."""

    def __init__(self, out_ch: int = 256, quant_mode: str = "off"):
        super().__init__()
        conv = partial(conv_for, quant_mode)
        # Inputs are ResNet-50's C3/C4/C5: 512/1024/2048 channels.
        self.latlayer1 = conv(2048, out_ch, 1)  # lat5
        self.latlayer2 = conv(1024, out_ch, 1)  # lat4
        self.latlayer3 = conv(512, out_ch, 1)  # lat3
        self.toplayer0 = conv(out_ch, out_ch, 3, padding=1)  # smooth5
        self.toplayer1 = conv(out_ch, out_ch, 3, padding=1)  # smooth4
        self.toplayer2 = conv(out_ch, out_ch, 3, padding=1)  # smooth3
        self.conv6 = conv(2048, out_ch, 3, stride=2, padding=1)  # p6
        self.conv7 = conv(out_ch, out_ch, 3, stride=2, padding=1)  # p7

    def forward(self, c3: Tensor, c4: Tensor, c5: Tensor, spatial=None,
                shard_flags: tuple[bool, bool, bool] | None = None) -> tuple[Tensor, ...]:
        f3, f4, f5 = shard_flags or (False, False, False)

        def conv3(conv, x: Tensor, sharded: bool, name: str) -> tuple[Tensor, bool]:
            if sharded and halo_plan(x.shape[2], 3, conv.stride[0], 1) is None:
                x, sharded = spatial.reshard(x, f"fpn.{name}"), False
            return conv_rows(conv, x, spatial if sharded else None), sharded

        p5 = conv_rows(self.latlayer1, c5, spatial if f5 else None)
        p4 = conv_rows(self.latlayer2, c4, spatial if f4 else None)
        p3 = conv_rows(self.latlayer3, c3, spatial if f3 else None)
        if f4 and not f5:
            p4, f4 = spatial.reshard(p4, "fpn.lat4"), False
        p4 = p4 + F.interpolate(p5, size=p4.shape[-2:], mode="nearest")
        if f3 and not f4:
            p3, f3 = spatial.reshard(p3, "fpn.lat3"), False
        p3 = p3 + F.interpolate(p4, size=p3.shape[-2:], mode="nearest")
        p3, f3 = conv3(self.toplayer2, p3, f3, "smooth3")
        p4, f4 = conv3(self.toplayer1, p4, f4, "smooth4")
        p5, fp5 = conv3(self.toplayer0, p5, f5, "smooth5")
        p6, f6 = conv3(self.conv6, c5, f5, "p6")
        p7, f7 = conv3(self.conv7, F.relu(p6), f6, "p7")
        return tuple(spatial.reshard(p, f"fpn.out{i + 3}") if f else p
                     for i, (p, f) in enumerate(zip((p3, p4, p5, p6, p7), (f3, f4, fp5, f6, f7))))
