"""Plain PyTorch reference of ZSGNet (Sadhu, Chen & Nevatia, ICCV 2019,
arXiv:1908.07129): the image backbone, the BiLSTM query encoder, the fusion
head and the anchor pyramid, written from the published description with
``torch.nn.functional`` operations over a dict of named tensors.

Backbones:

* ``retina``: ResNet-50 (bottleneck v1.5, BatchNorm eps 1e-5) and an FPN
  P3–P7 of ``fpn_ch`` channels (1×1 laterals, nearest top-down upsampling,
  3×3 smoothing, P6 a 3×3/2 conv on C5, P7 a 3×3/2 conv on relu(P6));
* ``ssd_vgg``: SSD300's VGG-16 (Liu et al., arXiv:1512.02325, as
  amdegroot/ssd.pytorch builds it): ceil-mode pool3, 3×3/1 pool5, conv6
  dilated 6, conv7 1×1, L2Norm (scale 20) on conv4_3, and four extras
  blocks; six source maps on their native channels.

At every level the head sees [visual | query broadcast | (y, x) cell-centre
grid] and runs 4×(conv3×3 + ReLU) and a conv3×3 to A·5 channels, per anchor
(score, dy, dx, dh, dw). The LSTM has one bias per direction (the sum of the
``bias_ih`` and ``bias_hh`` rows of the state dict).

The tensors are named as the state dicts of the system under test name
them, so one seeded dict feeds both. Nothing here imports the system
under test. ``conv``, where given, computes every convolution in place of
``F.conv2d`` (same arguments): the benchmark's lower-precision control
passes one in float8 there.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Conv = Callable[..., Tensor] | None

RESNET_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
RETINA_STRIDES = (8, 16, 32, 64, 128)
# VGG-16 configuration D to conv5_3: an int is a 3×3 conv's width, "M" a
# 2×2/2 max pool, "MC" the ceil-mode one. Module indices follow the flat
# ``nn.Sequential`` of amdegroot/ssd.pytorch (a conv and its ReLU take two).
VGG_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "MC", 512, 512, 512, "M", 512, 512, 512)
SSD_NATIVE_CHANNELS = (512, 1024, 512, 256, 256, 256)
# The extras: (in, out, kernel, stride, padding); padding None is SSD's VALID
# 3×3, which takes padding 1 on a map narrower than the kernel.
SSD_EXTRAS = ((1024, 256, 1, 1, 0), (256, 512, 3, 2, 1), (512, 128, 1, 1, 0), (128, 256, 3, 2, 1),
              (256, 128, 1, 1, 0), (128, 256, 3, 1, None), (256, 128, 1, 1, 0), (128, 256, 3, 1, None))
BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def num_anchors(cfg: dict) -> int:
    return len(cfg["ratios"]) * len(cfg["scales"])


def vgg_layers() -> list[tuple[int, str, tuple]]:
    """(module index, kind, args) of the VGG tower: ("conv", (cin, cout, k,
    pad, dil)), ("relu", ()), ("pool", (k, stride, pad, ceil))."""
    out, idx, cin = [], 0, 3
    for item in VGG_PLAN:
        if item in ("M", "MC"):
            out.append((idx, "pool", (2, 2, 0, item == "MC")))
            idx += 1
        else:
            out += [(idx, "conv", (cin, item, 3, 1, 1)), (idx + 1, "relu", ())]
            cin, idx = item, idx + 2
    out += [(idx, "pool", (3, 1, 1, False)),
            (idx + 1, "conv", (512, 1024, 3, 6, 6)), (idx + 2, "relu", ()),
            (idx + 3, "conv", (1024, 1024, 1, 0, 1)), (idx + 4, "relu", ())]
    return out


CONV4_3_RELU = 22  # the module index whose output goes through L2Norm


def param_shapes(cfg: dict, vocab_size: int) -> dict[str, tuple[str, tuple[int, ...]]]:
    """Every tensor of the model: name → (kind, shape). Kinds: ``conv``
    (a conv weight), ``zero`` (a conv bias), ``bn_w``, ``bn_w_residual`` (the
    last BatchNorm scale of a bottleneck's branch), ``bn_b``, ``bn_mean``,
    ``bn_var``, ``bn_count``, ``emb``, ``lstm`` (LSTM weights and
    ``bias_ih``), ``lstm_hh_bias`` (held at 0: the LSTM's one bias lives in
    ``bias_ih``), ``l2norm``, ``score_bias`` (a head's output bias)."""
    spec: dict[str, tuple[str, tuple[int, ...]]] = {}

    def conv(name: str, cin: int, cout: int, k: int, bias: bool = True) -> None:
        spec[f"{name}.weight"] = ("conv", (cout, cin, k, k))
        if bias:
            spec[f"{name}.bias"] = ("zero", (cout,))

    def bn(name: str, c: int) -> None:
        for sfx, kind in (("weight", "bn_w"), ("bias", "bn_b"), ("running_mean", "bn_mean"),
                          ("running_var", "bn_var")):
            spec[f"{name}.{sfx}"] = (kind, (c,))
        spec[f"{name}.num_batches_tracked"] = ("bn_count", ())

    if cfg["mdl_to_use"] == "retina":
        p = "backbone.encoder."
        conv(p + "conv1", 3, 64, 7, bias=False)
        bn(p + "bn1", 64)
        cin = 64
        for s, (n, w) in enumerate(RESNET_STAGES):
            for i in range(n):
                q = f"{p}layer{s + 1}.{i}."
                conv(q + "conv1", cin, w, 1, bias=False)
                bn(q + "bn1", w)
                conv(q + "conv2", w, w, 3, bias=False)
                bn(q + "bn2", w)
                conv(q + "conv3", w, 4 * w, 1, bias=False)
                bn(q + "bn3", 4 * w)
                spec[q + "bn3.weight"] = ("bn_w_residual", (4 * w,))
                if i == 0:
                    conv(q + "downsample.0", cin, 4 * w, 1, bias=False)
                    bn(q + "downsample.1", 4 * w)
                cin = 4 * w
        f, c = "backbone.fpn.", cfg["fpn_ch"]
        for name, cin_, k in (("latlayer1", 2048, 1), ("latlayer2", 1024, 1), ("latlayer3", 512, 1),
                              ("toplayer0", c, 3), ("toplayer1", c, 3), ("toplayer2", c, 3),
                              ("conv6", 2048, 3), ("conv7", c, 3)):
            conv(f + name, cin_, c, k)
        level_ch = (c,) * 5
    elif cfg["mdl_to_use"] == "ssd_vgg":
        for idx, kind, args in vgg_layers():
            if kind == "conv":
                conv(f"backbone.vgg.{idx}", args[0], args[1], args[2])
        spec["backbone.L2Norm.weight"] = ("l2norm", (512,))
        for i, (cin_, cout, k, _, _) in enumerate(SSD_EXTRAS):
            conv(f"backbone.extras.{i}", cin_, cout, k)
        level_ch = SSD_NATIVE_CHANNELS
    else:
        raise ValueError(f"unknown mdl_to_use {cfg['mdl_to_use']!r}")
    e, h = cfg["emb_dim"], cfg["lstm_dim"]
    spec["embedding.weight"] = ("emb", (vocab_size, e))
    for sfx in ("l0", "l0_reverse"):
        spec[f"lstm.weight_ih_{sfx}"] = ("lstm", (4 * h, e))
        spec[f"lstm.weight_hh_{sfx}"] = ("lstm", (4 * h, h))
        spec[f"lstm.bias_ih_{sfx}"] = ("lstm", (4 * h,))
        spec[f"lstm.bias_hh_{sfx}"] = ("lstm_hh_bias", (4 * h,))
    a = num_anchors(cfg)
    for p, ch in head_prefixes(cfg, level_ch):
        conv(p + "conv0", ch + 2 * h + 2, cfg["head_ch"], 3)
        for i in (1, 2, 3):
            conv(p + f"conv{i}", cfg["head_ch"], cfg["head_ch"], 3)
        conv(p + "out", cfg["head_ch"], 5 * a, 3)
        spec[p + "out.bias"] = ("score_bias", (5 * a,))
    return spec


def level_channels(cfg: dict) -> tuple[int, ...]:
    return (cfg["fpn_ch"],) * 5 if cfg["mdl_to_use"] == "retina" else SSD_NATIVE_CHANNELS


def head_prefixes(cfg: dict, level_ch: tuple[int, ...] | None = None) -> list[tuple[str, int]]:
    """(name prefix, visual channels) of each level's head: one shared
    ``head.`` where every level has the same channels, else ``heads.<i>.``."""
    level_ch = level_ch or level_channels(cfg)
    if cfg.get("use_same_atb", True) and len(set(level_ch)) == 1:
        return [("head.", level_ch[0])] * len(level_ch)
    return [(f"heads.{i}.", c) for i, c in enumerate(level_ch)]


def trainable(spec: dict[str, tuple[str, tuple]]) -> list[str]:
    """The names an optimizer updates: every parameter but the BatchNorm
    statistics and the held LSTM ``bias_hh``."""
    fixed = {"bn_mean", "bn_var", "bn_count", "lstm_hh_bias"}
    return [n for n, (kind, _) in spec.items() if kind not in fixed]


# ---------------------------------------------------------------- layers


def _conv(x: Tensor, P: dict, name: str, stride: int = 1, padding: int = 0, dilation: int = 1,
          conv: Conv = None) -> Tensor:
    return (conv or F.conv2d)(x, P[f"{name}.weight"], P.get(f"{name}.bias"), stride, padding, dilation)


def _bn(x: Tensor, P: dict, name: str, train: bool, group=None) -> Tensor:
    if train and group is None:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    elif train:  # the moments of every rank's rows, through a differentiable sum
        from torch.distributed.nn.functional import all_reduce

        count = x.numel() // x.shape[1] * torch.distributed.get_world_size(group)
        mean = all_reduce(x.sum(dim=(0, 2, 3)), group=group) / count
        var = all_reduce(((x - mean[None, :, None, None]) ** 2).sum(dim=(0, 2, 3)), group=group) / count
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    scale = P[f"{name}.weight"] * torch.rsqrt(var + BN_EPS)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + P[f"{name}.bias"][None, :, None, None]


def resnet50(x: Tensor, P: dict, train: bool, conv: Conv = None, group=None) -> list[Tensor]:
    """Normalized (B, 3, H, W) → C3, C4, C5. With ``group`` (a process
    group whose ranks hold the rest of the batch) the training-mode
    BatchNorm moments are the whole batch's."""
    p = "backbone.encoder."
    x = F.relu(_bn(_conv(x, P, p + "conv1", 2, 3, conv=conv), P, p + "bn1", train, group))
    x = F.max_pool2d(x, 3, 2, 1)
    taps = []
    for s, (n, _) in enumerate(RESNET_STAGES):
        for i in range(n):
            q = f"{p}layer{s + 1}.{i}."
            stride = 2 if (i == 0 and s > 0) else 1
            skip = x
            if i == 0:
                skip = _bn(_conv(x, P, q + "downsample.0", stride, conv=conv), P, q + "downsample.1", train, group)
            y = F.relu(_bn(_conv(x, P, q + "conv1", conv=conv), P, q + "bn1", train, group))
            y = F.relu(_bn(_conv(y, P, q + "conv2", stride, 1, conv=conv), P, q + "bn2", train, group))
            y = _bn(_conv(y, P, q + "conv3", conv=conv), P, q + "bn3", train, group)
            x = F.relu(y + skip)
        if s >= 1:
            taps.append(x)
    return taps


def fpn(c3: Tensor, c4: Tensor, c5: Tensor, P: dict, conv: Conv = None) -> list[Tensor]:
    f = "backbone.fpn."
    p5 = _conv(c5, P, f + "latlayer1", conv=conv)
    p4 = _conv(c4, P, f + "latlayer2", conv=conv)
    p3 = _conv(c3, P, f + "latlayer3", conv=conv)
    p4 = p4 + F.interpolate(p5, size=p4.shape[-2:], mode="nearest")
    p3 = p3 + F.interpolate(p4, size=p3.shape[-2:], mode="nearest")
    p3 = _conv(p3, P, f + "toplayer2", 1, 1, conv=conv)
    p4 = _conv(p4, P, f + "toplayer1", 1, 1, conv=conv)
    p5 = _conv(p5, P, f + "toplayer0", 1, 1, conv=conv)
    p6 = _conv(c5, P, f + "conv6", 2, 1, conv=conv)
    p7 = _conv(F.relu(p6), P, f + "conv7", 2, 1, conv=conv)
    return [p3, p4, p5, p6, p7]


def ssd_vgg16(x: Tensor, P: dict, conv: Conv = None) -> list[Tensor]:
    """Normalized (B, 3, H, W) → the six source maps."""
    sources = []
    for idx, kind, args in vgg_layers():
        if kind == "conv":
            x = _conv(x, P, f"backbone.vgg.{idx}", 1, args[3], args[4], conv=conv)
        elif kind == "relu":
            x = F.relu(x)
        else:
            k, s, pad, ceil = args
            x = F.max_pool2d(x, k, s, pad, ceil_mode=ceil)
        if idx == CONV4_3_RELU:
            norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)
            sources.append(x / norm * P["backbone.L2Norm.weight"][None, :, None, None])
    sources.append(x)
    for i, (_, _, k, s, pad) in enumerate(SSD_EXTRAS):
        if pad is None:
            pad = 1 if x.shape[2] < 3 else 0
        x = F.relu(_conv(x, P, f"backbone.extras.{i}", s, pad, conv=conv))
        if i % 2:
            sources.append(x)
    return sources


def bilstm(qvec: Tensor, qlens: Tensor, P: dict) -> Tensor:
    """(B, T) token ids, (B,) lengths ≥ 1 → (B, 2H): the forward state after
    each row's last token and the backward state after its first, by a
    masked scan over the longest row's steps."""
    x = P["embedding.weight"][qvec.long()]
    b = qvec.shape[0]
    steps = int(qlens.max())
    lens = qlens.to(x.device).long()
    out = []
    for sfx, order in (("l0", range(steps)), ("l0_reverse", reversed(range(steps)))):
        w_ih, w_hh = P[f"lstm.weight_ih_{sfx}"], P[f"lstm.weight_hh_{sfx}"]
        bias = P[f"lstm.bias_ih_{sfx}"] + P[f"lstm.bias_hh_{sfx}"]
        h = x.new_zeros((b, w_hh.shape[1]))
        c = torch.zeros_like(h)
        for t in order:
            gi, gf, gg, go = (x[:, t] @ w_ih.t() + h @ w_hh.t() + bias).chunk(4, dim=-1)
            c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h_new = torch.sigmoid(go) * torch.tanh(c_new)
            live = (lens > t)[:, None]
            c = torch.where(live, c_new, c)
            h = torch.where(live, h_new, h)
        out.append(h)
    return torch.cat(out, dim=-1)


def cell_grid(h: int, w: int, dtype: torch.dtype, device) -> Tensor:
    """(2, h, w): the normalized (y, x) centre of every cell."""
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) * (2.0 / h) - 1.0
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) * (2.0 / w) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gy, gx])


def head(f: Tensor, q: Tensor, P: dict, prefix: str, conv: Conv = None) -> Tensor:
    """One level: features (B_img, C, h, w), queries (N, 2H), N a multiple
    of B_img (each image's rows repeated to its queries) → (N, A·5, h, w)."""
    n = q.shape[0]
    if f.shape[0] != n:
        f = f.repeat_interleave(n // f.shape[0], dim=0)
    h, w = f.shape[-2:]
    x = torch.cat([f, q[:, :, None, None].expand(n, q.shape[1], h, w),
                   cell_grid(h, w, f.dtype, f.device)[None].expand(n, 2, h, w)], dim=1)
    for i in range(4):
        x = F.relu(_conv(x, P, f"{prefix}conv{i}", 1, 1, conv=conv))
    return _conv(x, P, f"{prefix}out", 1, 1, conv=conv)


def forward(cfg: dict, P: dict, img: Tensor, qvec: Tensor, qlens: Tensor, train: bool = False,
            conv: Conv = None, group=None) -> tuple[Tensor, Tensor]:
    """uint8 images (B, H, W, 3), token ids (N, T), lengths (N,) → score
    logits (N, A) and box deltas (N, A, 4), anchors in ``anchors()``'s
    order. ``train`` normalizes with the batch's moments (with ``group``,
    those of every rank's rows)."""
    dtype = P["embedding.weight"].dtype
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=img.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=img.device)[None, :, None, None]
    x = (img.permute(0, 3, 1, 2).to(dtype) / 255.0 - mean) / std
    if cfg["mdl_to_use"] == "retina":
        feats = fpn(*resnet50(x, P, train, conv, group), P, conv)
    else:
        feats = ssd_vgg16(x, P, conv)
    q = bilstm(qvec, qlens, P)
    a = num_anchors(cfg)
    att, bbx = [], []
    for f, (prefix, _) in zip(feats, head_prefixes(cfg)):
        out = head(f, q, P, prefix, conv)
        n, _, h, w = out.shape
        r = out.permute(0, 2, 3, 1).reshape(n, h * w * a, 5)
        att.append(r[..., 0])
        bbx.append(r[..., 1:])
    return torch.cat(att, dim=1), torch.cat(bbx, dim=1)


# ---------------------------------------------------------------- anchors


def level_sizes(cfg: dict) -> list[tuple[int, int]]:
    """(h, w) of every level's map at ``cfg["resize_img"]``."""
    h, w = cfg["resize_img"]
    if cfg["mdl_to_use"] == "retina":
        return [(math.ceil(h / s), math.ceil(w / s)) for s in RETINA_STRIDES]

    def out(n: int, k: int, s: int, p: int, d: int = 1) -> int:
        return (n + 2 * p - d * (k - 1) - 1) // s + 1

    sizes = []
    for idx, kind, args in vgg_layers():
        if kind == "pool":
            k, s, pad, ceil = args
            if ceil:
                h, w = -(-(h + 2 * pad - k) // s) + 1, -(-(w + 2 * pad - k) // s) + 1
            else:
                h, w = out(h, k, s, pad), out(w, k, s, pad)
        elif kind == "conv":
            _, _, k, pad, dil = args
            h, w = out(h, k, 1, pad, dil), out(w, k, 1, pad, dil)
        if idx == CONV4_3_RELU:
            sizes.append((h, w))
    sizes.append((h, w))
    for i, (_, _, k, s, pad) in enumerate(SSD_EXTRAS):
        ph = (1 if h < 3 else 0) if pad is None else pad
        pw = (1 if w < 3 else 0) if pad is None else pad
        h, w = out(h, k, s, ph), out(w, k, s, pw)
        if i % 2:
            sizes.append((h, w))
    return sizes


def anchors(cfg: dict, dtype: torch.dtype = torch.float64) -> Tensor:
    """(A, 4) anchors as (cy, cx, h, w) in the [-1, 1] frame: level-major,
    then row-major cells, then scale-major, ratio-minor; one cell's extent
    times scale·√ratio in height and scale/√ratio in width."""
    rows = []
    for h, w in level_sizes(cfg):
        grid = cell_grid(h, w, torch.float64, "cpu").permute(1, 2, 0).reshape(h * w, 1, 2)
        ext = torch.tensor([(2.0 / h * s * math.sqrt(r), 2.0 / w * s / math.sqrt(r))
                            for s in cfg["scales"] for r in cfg["ratios"]], dtype=torch.float64)
        a = ext.shape[0]
        rows.append(torch.cat([grid.expand(h * w, a, 2), ext[None].expand(h * w, a, 2)], -1).reshape(-1, 4))
    return torch.cat(rows).to(dtype)
