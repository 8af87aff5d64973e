"""ZSGNet — torch port of ``zsgnet_tpu/models/zsgnet.py``.

Image + query → per-anchor score logits and box deltas. The backbone is
ResNet-50 + FPN (``mdl_to_use="retina"``: P3–P7, ``fpn_ch`` channels) or
SSD-VGG16 (``"ssd_vgg"``: six maps, native channels 512/1024/512/256/256/256
or ``fpn_ch`` with ``ssd_uniform_proj``); a BiLSTM gives the query vector;
at every level a head sees the concatenation [visual | query broadcast |
(y, x) cell-center grid] and runs 4×(conv3×3 + ReLU) + conv3×3 → A·5
channels. This is the plain "concat then conv" form that the JAX
``PredictionHead`` evaluates in an exactly equivalent decomposed way. The
output conv keeps the reference's per-anchor interleaved channels
[a0:(score, dy, dx, dh, dw), a1:(…), …].

One head (``head``) is shared by every level when ``cfg.use_same_atb`` and
the levels' channels agree; otherwise each level has its own
(``heads.<i>``, the JAX ``head{i}``), whose first conv takes that level's
channels.

Outputs are flat, in ``ops.anchors.create_anchors`` order (level-major,
row-major cells, anchor within the cell): ``att_out`` (B, A) and
``bbx_out`` (B, A, 4), float32.

The ``state_dict`` keeps the reference checkpoint's names
(``backbone.encoder.*`` torchvision, ``backbone.fpn.*``, or the amdegroot
SSD names under ``backbone.``; ``embedding.weight``, ``lstm.*``,
``head.conv0..conv3``, ``head.out``), so
``zsgnet_tpu/convert/torch_import.py`` maps it onto the JAX model
unchanged; ``zsgnet_tpu_torch.convert`` goes the other way.

The image batch may be smaller than the query batch. One image against N
queries (``Grounder.ground_image``) expands each level's features to N
rows before the head. Grouped multi-query training (``qvec`` (B, Q, T),
``qlens`` (B, Q), ``cfg.queries_per_img``) runs the BiLSTM per pair and the
backbone once per image, and repeats each level's features to B·Q rows,
pair-major (image-major, query-minor): the same function as tiling every
image Q times, with gradients summed back through the repeat. The JAX head
adds its per-image conv0 term to the per-pair query term instead; here
conv0's visual channels are paid per pair.

``cfg.remat_backbone`` recomputes ResNet-50's bottlenecks in the backward
pass (``models/resnet.py``).

``cfg.compute_dtype == "bfloat16"`` runs the backbone and heads under
``torch.autocast`` on CUDA; the query encoder and the outputs stay float32.
Not ported yet: the canvas head and int8.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from zsgnet_tpu_torch.models.bilstm import encode_query, make_encoder
from zsgnet_tpu_torch.models.fpn import FPN
from zsgnet_tpu_torch.models.resnet import ResNet50
from zsgnet_tpu_torch.models.ssd_vgg import SSDVGG16, ssd_feature_map_sizes
from zsgnet_tpu_torch.ops import anchors as anchor_ops
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor

FOCAL_PRIOR_BIAS = -math.log((1.0 - 0.01) / 0.01)


class PredictionHead(nn.Module):
    """Fusion head: 4×(conv3×3 + ReLU), then conv3×3 → A·5 channels,
    per-anchor interleaved."""

    def __init__(self, in_ch: int, mid_ch: int, num_anchors: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, mid_ch, 3, padding=1)
        self.conv1 = nn.Conv2d(mid_ch, mid_ch, 3, padding=1)
        self.conv2 = nn.Conv2d(mid_ch, mid_ch, 3, padding=1)
        self.conv3 = nn.Conv2d(mid_ch, mid_ch, 3, padding=1)
        self.out = nn.Conv2d(mid_ch, num_anchors * 5, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        for conv in (self.conv0, self.conv1, self.conv2, self.conv3):
            x = torch.relu(conv(x))
        return self.out(x)


class ZSGNet(nn.Module):
    def __init__(self, cfg: Config, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        if cfg.mdl_to_use == "retina":
            self.backbone = nn.ModuleDict({
                "encoder": ResNet50(remat=cfg.remat_backbone), "fpn": FPN(cfg.fpn_ch),
            })
            channels = (cfg.fpn_ch,) * 5
        elif cfg.mdl_to_use == "ssd_vgg":
            self.backbone = SSDVGG16(cfg.fpn_ch, uniform_proj=cfg.ssd_uniform_proj)
            channels = self.backbone.channels
        else:
            raise ValueError(f"unknown mdl_to_use: {cfg.mdl_to_use}")
        self.embedding, self.lstm = make_encoder(vocab_size, cfg.emb_dim, cfg.lstm_dim)

        def head(vis_ch: int) -> PredictionHead:
            return PredictionHead(vis_ch + cfg.lang_dim + 2, cfg.head_ch, cfg.num_anchors)

        if cfg.use_same_atb and len(set(channels)) == 1:
            self.head = head(channels[0])
            self.level_heads = [self.head] * len(channels)
        else:
            self.heads = nn.ModuleList(head(c) for c in channels)
            self.level_heads = list(self.heads)
        self.register_buffer("img_mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("img_std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False)
        self._grids: dict[tuple, Tensor] = {}

    def _grid(self, h: int, w: int, device: torch.device) -> Tensor:
        key = (h, w, str(device))
        if key not in self._grids:
            grid = anchor_ops.create_grid((h, w), flatten=False).transpose(2, 0, 1)
            self._grids[key] = torch.from_numpy(np.ascontiguousarray(grid))[None].to(device)
        return self._grids[key]

    def _features(self, x: Tensor) -> tuple[Tensor, ...]:
        if self.cfg.mdl_to_use == "retina":
            return self.backbone["fpn"](*self.backbone["encoder"](x))
        return self.backbone(x)

    def forward(self, img: Tensor, qvec: Tensor, qlens: Tensor) -> dict:
        """img (B, H, W, 3) uint8 (normalized here, in float32) or float
        already normalized; qvec (N, T) int and qlens (N,) int with N a
        multiple of B (B = 1 against N queries, or B = N), or grouped:
        qvec (B, Q, T) and qlens (B, Q), N = B·Q pairs, pair-major."""
        if qvec.dim() == 3:
            qvec = qvec.reshape(-1, qvec.shape[-1])
            qlens = qlens.reshape(-1)
        x = img.permute(0, 3, 1, 2)
        if img.dtype == torch.uint8:
            x = (x.float() / 255.0 - self.img_mean) / self.img_std
        x = x.to(self.img_mean.dtype).contiguous()  # float32, or float64 after model.double()
        bf16 = self.cfg.compute_dtype == "bfloat16" and x.is_cuda
        autocast = (
            torch.autocast("cuda", dtype=torch.bfloat16) if bf16 else contextlib.nullcontext()
        )
        q = encode_query(self.embedding, self.lstm, qvec, qlens)  # float32
        b, a = q.shape[0], self.cfg.num_anchors
        if b % x.shape[0]:
            raise ValueError(f"{b} queries do not divide among {x.shape[0]} images")
        reps = b // x.shape[0]
        atts, bbxs, feat_sizes = [], [], []
        with autocast:
            feats = self._features(x)
            for f, head in zip(feats, self.level_heads):
                if reps > 1:  # each image to its queries' rows, pair-major
                    f = f.expand(b, -1, -1, -1) if f.shape[0] == 1 else f.repeat_interleave(reps, dim=0)
                _, _, h, w = f.shape
                lang = q[:, :, None, None].to(f.dtype).expand(b, q.shape[1], h, w)
                grid = self._grid(h, w, f.device).to(f.dtype).expand(b, 2, h, w)
                out = head(torch.cat([f, lang, grid], dim=1)).float()
                r = out.permute(0, 2, 3, 1).reshape(b, h * w * a, 5)
                atts.append(r[..., 0])
                bbxs.append(r[..., 1:5])
                feat_sizes.append((h, w))
        return {
            "att_out": torch.cat(atts, dim=1),
            "bbx_out": torch.cat(bbxs, dim=1),
            "feat_sizes": tuple(feat_sizes),
            "num_f_out": len(feats),
        }


@torch.no_grad()
def init_weights(model: ZSGNet, seed: int = 0) -> ZSGNet:
    """Seeded random weights from an explicit ``torch.Generator``: LeCun-normal
    convs with zero biases, identity BatchNorm statistics, N(0, 1) embeddings,
    U(±1/√H) LSTM weights, L2Norm's scale of 20, and the focal prior on every
    head's score biases.
    Runs on the CPU before the model is moved to its device."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=g)
        elif isinstance(m, nn.LSTM):
            k = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-k, k, generator=g)
            for sfx in ("l0", "l0_reverse"):  # the frozen bias_hh into bias_ih (fold_lstm_bias_)
                getattr(m, f"bias_ih_{sfx}").add_(getattr(m, f"bias_hh_{sfx}"))
                getattr(m, f"bias_hh_{sfx}").zero_()
    for head in model.level_heads:
        head.out.bias[0::5] = FOCAL_PRIOR_BIAS
    return model


def get_default_net(
    cfg: Config, vocab_size: int | None = None, *, seed: int = 0,
    device: str | torch.device = "cuda",
) -> ZSGNet:
    """A ZSGNet with seeded random weights, in eval mode, on ``device``."""
    dev = resolve_device(device)
    vs = vocab_size or cfg.vocab_size or 10000
    return init_weights(ZSGNet(cfg, vs), seed).to(dev).eval()


def pyramid_sizes_for(cfg: Config) -> tuple[tuple[int, int], ...]:
    if cfg.mdl_to_use == "retina":
        return anchor_ops.feature_map_sizes(cfg.resize_img)
    return ssd_feature_map_sizes(cfg.resize_img)


def anchor_pyramid_for(cfg: Config) -> np.ndarray:
    """The (A, 4) cthw anchor constant matching ZSGNet's output ordering."""
    return anchor_ops.create_anchors(cfg.scales, cfg.ratios, pyramid_sizes_for(cfg))
