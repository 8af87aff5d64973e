"""SSD-VGG16 backbone — torch port of ``zsgnet_tpu/models/ssd_vgg.py``.

VGG-16 up to conv5_3 with SSD's changes (ceil-mode pool3, 3×3/1 pool5,
dilated conv6, 1×1 conv7) and the four extras blocks: six source maps, at
300² 38²·512 (conv4_3 through ``L2Norm``), 19²·1024 (conv7), 10²·512,
5²·256, 3²·256 and 1²·256. No BatchNorm, so ``train`` changes nothing.

The ``state_dict`` has amdegroot/ssd.pytorch's names: ``vgg.<i>`` at the
indices of that repository's flat ``nn.Sequential`` (``vgg16_reducedfc.pth``),
``L2Norm.weight`` and ``extras.<i>``, which
``zsgnet_tpu/convert/torch_import.py::convert_vgg16_ssd`` reads. With
``uniform_proj`` 1×1 convolutions ``proj.<i>`` bring every map to
``out_ch`` channels (the JAX ``proj{i}``), so a shared head fits them all.

The extras' last two 3×3 convolutions take padding 1 when their input is
narrower than 3 (small images), as :func:`ssd_feature_map_sizes` counts.

``quant_mode`` builds the VGG and extras convolutions through
``models.quant.conv_for``; the ``proj.<i>`` stay float, as in the JAX
package.

``forward(x, spatial=ctx)`` (``parallel.halo``, the port's counterpart of
the JAX ``gspmd`` spatial mode) takes this member's rows of the image: the
VGG tower runs split by height, every convolution and max pool taking its
halo rows (``conv_rows``, ``max_pool_rows``; conv6's dilation widens its
halo to 6 rows), until the first layer whose local height ``halo_plan``
rejects, which is preceded by the reshard (or, for a batch that the group
does not divide, the gather). ``L2Norm`` is channel-wise and runs on a
shard unchanged. A source map still split when it leaves the tower (the
conv4_3 tap, conv7) is resharded first, so the extras, whose adaptive
padding reads the height, see whole maps.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from zsgnet_tpu_torch.models.quant import QuantConv2d, conv_for
from zsgnet_tpu_torch.parallel.halo import conv_rows, halo_plan, max_pool_rows

Tensor = torch.Tensor

# VGG-16 cfg 'D' up to conv5_3; "M" a 2×2/2 max pool, "MC" the ceil-mode one.
_VGG_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "MC", 512, 512, 512, "M", 512, 512, 512)
CONV4_3 = 22  # the ReLU after conv4_3: its output goes through L2Norm
NATIVE_CHANNELS = (512, 1024, 512, 256, 256, 256)


def ssd_feature_map_sizes(img_size: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """Source-map sizes for the SSD tower (input 300² → 38, 19, 10, 5, 3, 1)."""
    h, w = int(img_size[0]), int(img_size[1])

    def conv_out(n: int, k: int, s: int, p: int, d: int = 1) -> int:
        return (n + 2 * p - d * (k - 1) - 1) // s + 1

    h1, w1 = h // 2, w // 2
    h2, w2 = h1 // 2, w1 // 2
    h3, w3 = math.ceil(h2 / 2), math.ceil(w2 / 2)  # ceil-mode pool3
    s1 = (h3, w3)  # conv4_3
    h4, w4 = h3 // 2, w3 // 2
    s2 = (h4, w4)  # conv7: pool5 is 3×3/1/pad 1, conv6 keeps the size
    h5, w5 = conv_out(h4, 3, 2, 1), conv_out(w4, 3, 2, 1)
    s3 = (h5, w5)
    h6, w6 = conv_out(h5, 3, 2, 1), conv_out(w5, 3, 2, 1)
    s4 = (h6, w6)
    # The last two blocks are VALID 3×3 at 300²; below the kernel size
    # padding 1 keeps the map alive (SSDVGG16's adaptive padding).
    p5h, p5w = (1 if h6 < 3 else 0), (1 if w6 < 3 else 0)
    h7, w7 = conv_out(h6, 3, 1, p5h), conv_out(w6, 3, 1, p5w)
    s5 = (h7, w7)
    p6h, p6w = (1 if h7 < 3 else 0), (1 if w7 < 3 else 0)
    h8, w8 = conv_out(h7, 3, 1, p6h), conv_out(w7, 3, 1, p6w)
    s6 = (h8, w8)
    return (s1, s2, s3, s4, s5, s6)


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learned per-channel scale (init
    20), in float32 for 16- and 32-bit inputs (float64 for a float64 one);
    returns the input's type."""

    def __init__(self, channels: int = 512, init_scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), init_scale))

    def forward(self, x: Tensor) -> Tensor:
        xc = x.to(torch.promote_types(x.dtype, torch.float32))
        norm = torch.sqrt((xc * xc).sum(dim=1, keepdim=True) + 1e-10)
        return (xc / norm * self.weight.to(xc.dtype)[None, :, None, None]).to(x.dtype)


class CeilMaxPool(nn.Module):
    """2×2/2 max pool in ceil mode: an odd height or width is padded at the
    bottom or right with −inf first."""

    def forward(self, x: Tensor) -> Tensor:
        ph, pw = x.shape[2] % 2, x.shape[3] % 2
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
        return F.max_pool2d(x, 2, 2)


def _vgg_layers(quant_mode: str = "off") -> list[nn.Module]:
    """amdegroot's ``vgg(base['300'], 3)``: conv/ReLU pairs and pools, then
    pool5, conv6 (dilation 6), conv7; conv indices 0, 2, 5, …, 31, 33."""
    conv = partial(conv_for, quant_mode)
    layers: list[nn.Module] = []
    in_ch = 3
    for item in _VGG_PLAN:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        elif item == "MC":
            layers.append(CeilMaxPool())
        else:
            layers += [conv(in_ch, item, 3, padding=1), nn.ReLU()]
            in_ch = item
    layers += [
        nn.MaxPool2d(3, 1, 1),
        conv(512, 1024, 3, padding=6, dilation=6), nn.ReLU(),
        conv(1024, 1024, 1), nn.ReLU(),
    ]
    return layers


def _pool_geometry(layer: nn.Module) -> tuple[int, int, int]:
    """(k, stride, pad) of a VGG max pool; the ceil-mode pool is 2×2/2."""
    if isinstance(layer, CeilMaxPool):
        return 2, 2, 0
    return layer.kernel_size, layer.stride, layer.padding


def _shardable(layer: nn.Module, h_local: int) -> bool:
    """Whether a VGG layer runs on a height shard of ``h_local`` rows. The
    ceil-mode pool needs an even local height, so the global height is even
    and ceil equals floor."""
    if isinstance(layer, nn.Conv2d):
        return halo_plan(h_local, layer.kernel_size[0], layer.stride[0], layer.padding[0],
                         layer.dilation[0]) is not None
    if isinstance(layer, (nn.MaxPool2d, CeilMaxPool)):
        return halo_plan(h_local, *_pool_geometry(layer)) is not None
    return True  # ReLU


def _on_rows(layer: nn.Module, x: Tensor, spatial) -> Tensor:
    """A VGG layer on a height shard (the caller checked :func:`_shardable`)."""
    if isinstance(layer, nn.Conv2d):
        return conv_rows(layer, x, spatial)
    if isinstance(layer, nn.MaxPool2d):
        return max_pool_rows(x, spatial, *_pool_geometry(layer))
    return layer(x)  # ReLU; the ceil-mode pool pads only the width on an even shard


class SSDVGG16(nn.Module):
    """(B, 3, H, W) normalized image → 6 source maps, NCHW: native channels
    (``NATIVE_CHANNELS``), or ``out_ch`` each with ``uniform_proj``."""

    def __init__(self, out_ch: int = 256, uniform_proj: bool = False, quant_mode: str = "off"):
        super().__init__()
        conv = partial(conv_for, quant_mode)
        self.vgg = nn.ModuleList(_vgg_layers(quant_mode))
        self.L2Norm = L2Norm(512)
        self.extras = nn.ModuleList([
            conv(1024, 256, 1), conv(256, 512, 3, stride=2, padding=1),
            conv(512, 128, 1), conv(128, 256, 3, stride=2, padding=1),
            conv(256, 128, 1), conv(128, 256, 3),
            conv(256, 128, 1), conv(128, 256, 3),
        ])
        self.proj = (
            nn.ModuleList(nn.Conv2d(c, out_ch, 1) for c in NATIVE_CHANNELS) if uniform_proj else None
        )
        self.channels = (out_ch,) * 6 if uniform_proj else NATIVE_CHANNELS

    def forward(self, x: Tensor, spatial=None) -> tuple[Tensor, ...]:
        """Under ``spatial`` ``x`` is this member's rows and the maps are its
        batch block (every member's whole batch where the group gathered)."""
        sharded = spatial is not None
        sources = []
        for i, layer in enumerate(self.vgg):
            if sharded and not _shardable(layer, x.shape[2]):
                x, sharded = spatial.reshard(x, f"vgg.{i}"), False
            x = _on_rows(layer, x, spatial) if sharded else layer(x)
            if i == CONV4_3:
                src = self.L2Norm(x)
                sources.append(spatial.reshard(src, "conv4_3") if sharded else src)
        if sharded:
            x = spatial.reshard(x, "conv7")
        sources.append(x)  # conv7
        for i, conv in enumerate(self.extras):
            if i in (5, 7):  # VALID 3×3, padding 1 below the kernel size
                pad = 1 if x.shape[2] < 3 else 0
                x = conv(x, padding=pad) if isinstance(conv, QuantConv2d) else F.conv2d(
                    x, conv.weight, conv.bias, padding=pad)
            else:
                x = conv(x)
            x = F.relu(x)
            if i % 2:
                sources.append(x)
        if self.proj is None:
            return tuple(sources)
        return tuple(p(s) for p, s in zip(self.proj, sources))
