"""ZSGNet — torch port of ``zsgnet_tpu/models/zsgnet.py`` (retina, flat head).

Image + query → per-anchor score logits and box deltas. ResNet-50 + FPN
give P3–P7; a BiLSTM gives the query vector; at every level the shared head
sees the concatenation [visual | query broadcast | (y, x) cell-center grid]
and runs 4×(conv3×3 + ReLU) + conv3×3 → A·5 channels. This is the plain
"concat then conv" form that the JAX ``PredictionHead`` evaluates in an
exactly equivalent decomposed way. The output conv keeps the reference's
per-anchor interleaved channels [a0:(score, dy, dx, dh, dw), a1:(…), …].

Outputs are flat, in ``ops.anchors.create_anchors`` order (level-major,
row-major cells, anchor within the cell): ``att_out`` (B, A) and
``bbx_out`` (B, A, 4), float32.

The ``state_dict`` keeps the reference checkpoint's names
(``backbone.encoder.*`` torchvision, ``backbone.fpn.*``,
``embedding.weight``, ``lstm.*``, ``head.conv0..conv3``, ``head.out``), so
``zsgnet_tpu/convert/torch_import.py::convert_zsgnet_checkpoint`` maps it onto
the JAX model unchanged; ``zsgnet_tpu_torch.convert`` goes the other way.

An image batch of 1 against a query batch of N runs the backbone and the
FPN once and expands each level's features to N rows before the head: the
same computation as tiling the image N times (``Grounder.ground_image``).

``cfg.compute_dtype == "bfloat16"`` runs the backbone, FPN and head under
``torch.autocast`` on CUDA; the query encoder and the outputs stay float32.
Not ported yet: the SSD-VGG backbone, per-level heads
(``use_same_atb=False``), grouped multi-query, the canvas head and int8.
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
from zsgnet_tpu_torch.ops import anchors as anchor_ops
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor

FOCAL_PRIOR_BIAS = -math.log((1.0 - 0.01) / 0.01)


class PredictionHead(nn.Module):
    """Shared fusion head: 4×(conv3×3 + ReLU), then conv3×3 → A·5 channels,
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
        if cfg.mdl_to_use != "retina" or not cfg.use_same_atb or cfg.queries_per_img != 1:
            raise NotImplementedError(
                "the port runs the retina model with a shared head and one query "
                "per image (mdl_to_use='retina', use_same_atb=True, queries_per_img=1)"
            )
        self.cfg = cfg
        self.backbone = nn.ModuleDict({"encoder": ResNet50(), "fpn": FPN(cfg.fpn_ch)})
        self.embedding, self.lstm = make_encoder(vocab_size, cfg.emb_dim, cfg.lstm_dim)
        self.head = PredictionHead(cfg.fpn_ch + cfg.lang_dim + 2, cfg.head_ch, cfg.num_anchors)
        self.register_buffer("img_mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("img_std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False)
        self._grids: dict[tuple, Tensor] = {}

    def _grid(self, h: int, w: int, device: torch.device) -> Tensor:
        key = (h, w, str(device))
        if key not in self._grids:
            grid = anchor_ops.create_grid((h, w), flatten=False).transpose(2, 0, 1)
            self._grids[key] = torch.from_numpy(np.ascontiguousarray(grid))[None].to(device)
        return self._grids[key]

    def forward(self, img: Tensor, qvec: Tensor, qlens: Tensor) -> dict:
        """img (B, H, W, 3) uint8 (normalized here, in float32) or float
        already normalized, B equal to the query batch or 1; qvec (B, T)
        int; qlens (B,) int."""
        x = img.permute(0, 3, 1, 2)
        if img.dtype == torch.uint8:
            x = (x.float() / 255.0 - self.img_mean) / self.img_std
        x = x.float().contiguous()
        bf16 = self.cfg.compute_dtype == "bfloat16" and x.is_cuda
        autocast = (
            torch.autocast("cuda", dtype=torch.bfloat16) if bf16 else contextlib.nullcontext()
        )
        q = encode_query(self.embedding, self.lstm, qvec, qlens)  # float32
        b, a = q.shape[0], self.cfg.num_anchors
        atts, bbxs, feat_sizes = [], [], []
        with autocast:
            feats = self.backbone["fpn"](*self.backbone["encoder"](x))
            for f in feats:
                f = f.expand(b, -1, -1, -1)  # a batch-1 image to the query batch
                _, _, h, w = f.shape
                lang = q[:, :, None, None].to(f.dtype).expand(b, q.shape[1], h, w)
                grid = self._grid(h, w, f.device).to(f.dtype).expand(b, 2, h, w)
                out = self.head(torch.cat([f, lang, grid], dim=1)).float()
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
    U(±1/√H) LSTM weights, and the focal prior on the head's score biases.
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
    model.head.out.bias[0::5] = FOCAL_PRIOR_BIAS
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
    if cfg.mdl_to_use != "retina":
        raise NotImplementedError("the port's anchor pyramid is the retina one")
    return anchor_ops.feature_map_sizes(cfg.resize_img)


def anchor_pyramid_for(cfg: Config) -> np.ndarray:
    """The (A, 4) cthw anchor constant matching ZSGNet's output ordering."""
    return anchor_ops.create_anchors(cfg.scales, cfg.ratios, pyramid_sizes_for(cfg))
