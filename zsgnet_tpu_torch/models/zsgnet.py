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
pass (``models/resnet.py``). ``cfg.bn_sync_axis`` (set by the Learner under
a data mesh) takes ResNet-50's training-mode BatchNorm moments over every
rank of the process group.

``forward(..., spatial=ctx)`` (``parallel.halo``) takes this member's rows
of the image (all B samples, H/S rows): ResNet-50 and the FPN, or the
SSD-VGG16 tower, exchange halos and reshard (``models/resnet.py``,
``models/fpn.py``, ``models/ssd_vgg.py``), and the queries are sliced to
the member's batch block after the visual stream, so every output carries
that block (B/S rows; all B rows where the group gathered a batch that S
does not divide). The head and its canvas run on it unchanged.

``cfg.compute_dtype == "bfloat16"`` runs the backbone and heads under
``torch.autocast`` on CUDA; the query encoder and the outputs stay float32.

``cfg.head_canvas`` (with a shared head) runs the head once over one
canvas that holds every level's [visual | query | grid] input
(``models/canvas.py``); ``forward(canvas=...)`` overrides it per call. The
parameters are the same, so checkpoints and ``state_dict_from_jax`` serve
either head.

``cfg.quant_mode`` other than "off" builds the convolutions that the JAX
package routes through ``conv_for`` as ``models.quant.QuantConv2d``
(calibration or int8); with ``cfg.quant_head`` the head's conv1..out too,
and conv0's visual channels under their own ``vis_absmax_{H}x{W}``, its
query and grid channels staying in floating point.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from zsgnet_tpu_torch.models.bilstm import encode_query, encode_query_masked, make_encoder
from zsgnet_tpu_torch.models.canvas import canvas_constants, pack_levels
from zsgnet_tpu_torch.models.fpn import FPN
from zsgnet_tpu_torch.models.quant import ScaleBuffers, conv_for, parse_quant_mode, quantized_conv
from zsgnet_tpu_torch.models.resnet import ResNet50
from zsgnet_tpu_torch.models.ssd_vgg import SSDVGG16, ssd_feature_map_sizes
from zsgnet_tpu_torch.ops import anchors as anchor_ops
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor

FOCAL_PRIOR_BIAS = -math.log((1.0 - 0.01) / 0.01)


class PredictionHead(ScaleBuffers, nn.Module):
    """Fusion head over [visual (``vis_ch``) | query | grid]: 4×(conv3×3 +
    ReLU), then conv3×3 → A·5 channels, per-anchor interleaved.

    ``occupancy`` (canvas mode) multiplies every ReLU's output, re-zeroing
    the canvas's gap cells. In int8 mode conv0 is computed as
    ``int8_conv(vis, W[:, :Cv]) + conv([query, grid], W[:, Cv:]) + bias``
    (:meth:`conv0_split`), with the visual channels' scale
    ``vis_absmax_{H}x{W}``; conv1..out are ``QuantConv2d``."""

    def __init__(self, vis_ch: int, lang_ch: int, mid_ch: int, num_anchors: int, quant_mode: str = "off"):
        super().__init__()
        self.vis_ch = vis_ch
        self.mode, self.percentile = parse_quant_mode(quant_mode)
        self.conv0 = nn.Conv2d(vis_ch + lang_ch + 2, mid_ch, 3, padding=1)
        self.conv1 = conv_for(quant_mode, mid_ch, mid_ch, 3, padding=1)
        self.conv2 = conv_for(quant_mode, mid_ch, mid_ch, 3, padding=1)
        self.conv3 = conv_for(quant_mode, mid_ch, mid_ch, 3, padding=1)
        self.out = conv_for(quant_mode, mid_ch, num_anchors * 5, 3, padding=1)

    def conv0_split(self, x: Tensor, vis_conv) -> Tensor:
        """conv0 as ``vis_conv(visual, W[:, :Cv])`` plus the float conv of
        the query and grid channels plus the bias."""
        cv, w = self.vis_ch, self.conv0.weight
        rest = F.conv2d(x[:, cv:], w[:, cv:], None, padding=1)
        return vis_conv(x[:, :cv], w[:, :cv]) + rest + self.conv0.bias[:, None, None]

    def _conv0(self, x: Tensor) -> Tensor:
        if self.mode == "int8":
            return self.conv0_split(x, lambda v, w: quantized_conv(v, self.absmax("vis", v), w, None, 1, 1))
        if self.mode == "calib":
            with torch.no_grad():
                self.record("vis", x[:, : self.vis_ch], self.percentile)
        return self.conv0(x)

    def forward(self, x: Tensor, occupancy: Tensor | None = None) -> Tensor:
        x = torch.relu(self._conv0(x))
        for conv in (self.conv1, self.conv2, self.conv3):
            if occupancy is not None:
                x = x * occupancy
            x = torch.relu(conv(x))
        if occupancy is not None:
            x = x * occupancy
        return self.out(x)


class ZSGNet(nn.Module):
    def __init__(self, cfg: Config, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        qm = cfg.quant_mode
        if cfg.mdl_to_use == "retina":
            self.backbone = nn.ModuleDict({
                "encoder": ResNet50(remat=cfg.remat_backbone, quant_mode=qm,
                                    sync_bn=bool(cfg.bn_sync_axis), spd_stem=cfg.spd_stem),
                "fpn": FPN(cfg.fpn_ch, quant_mode=qm),
            })
            channels = (cfg.fpn_ch,) * 5
        elif cfg.mdl_to_use == "ssd_vgg":
            self.backbone = SSDVGG16(cfg.fpn_ch, uniform_proj=cfg.ssd_uniform_proj, quant_mode=qm)
            channels = self.backbone.channels
        else:
            raise ValueError(f"unknown mdl_to_use: {cfg.mdl_to_use}")
        self.embedding, self.lstm = make_encoder(vocab_size, cfg.emb_dim, cfg.lstm_dim)
        head_mode = qm if cfg.quant_head else "off"

        def head(vis_ch: int) -> PredictionHead:
            return PredictionHead(vis_ch, cfg.lang_dim, cfg.head_ch, cfg.num_anchors, head_mode)

        if cfg.use_same_atb and len(set(channels)) == 1:
            self.head = head(channels[0])
            self.level_heads = [self.head] * len(channels)
        else:
            self.heads = nn.ModuleList(head(c) for c in channels)
            self.level_heads = list(self.heads)
        self.register_buffer("img_mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("img_std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False)
        self._grids: dict[tuple, Tensor] = {}
        self._canvases: dict[tuple, tuple] = {}

    def _grid(self, h: int, w: int, device: torch.device) -> Tensor:
        key = (h, w, str(device))
        if key not in self._grids:
            grid = anchor_ops.create_grid((h, w), flatten=False).transpose(2, 0, 1)
            self._grids[key] = torch.from_numpy(np.ascontiguousarray(grid))[None].to(device)
        return self._grids[key]

    def _canvas(self, sizes: tuple, device: torch.device) -> tuple:
        """(layout, grid (1, 2, H, W), occupancy (1, 1, H, W)) of the canvas
        for these level sizes."""
        key = (sizes, str(device))
        if key not in self._canvases:
            layout = pack_levels(sizes)
            consts = canvas_constants(layout)
            chw = [torch.from_numpy(np.ascontiguousarray(consts[k].transpose(2, 0, 1)))[None].to(device)
                   for k in ("grid", "occupancy")]
            self._canvases[key] = (layout, *chw)
        return self._canvases[key]

    def _features(self, x: Tensor, spatial=None) -> tuple[Tensor, ...]:
        if self.cfg.mdl_to_use == "retina":
            if spatial is not None:
                feats, flags = self.backbone["encoder"](x, spatial)
                return self.backbone["fpn"](*feats, spatial=spatial, shard_flags=flags)
            return self.backbone["fpn"](*self.backbone["encoder"](x))
        return self.backbone(x, spatial)

    @staticmethod
    def _to_pairs(f: Tensor, b: int) -> Tensor:
        """Each image's rows to its queries' rows, pair-major."""
        if f.shape[0] == b:
            return f
        return f.expand(b, -1, -1, -1) if f.shape[0] == 1 else f.repeat_interleave(b // f.shape[0], dim=0)

    def _level_head(self, f: Tensor, q: Tensor, head: PredictionHead) -> Tensor:
        b = q.shape[0]
        f = self._to_pairs(f, b)
        _, _, h, w = f.shape
        lang = q[:, :, None, None].to(f.dtype).expand(b, q.shape[1], h, w)
        grid = self._grid(h, w, f.device).to(f.dtype).expand(b, 2, h, w)
        return head(torch.cat([f, lang, grid], dim=1))

    def _canvas_head(self, feats: tuple, q: Tensor) -> list[Tensor]:
        """The shared head once over the canvas; each level's output sliced
        back out."""
        f0 = feats[0]
        layout, grid, occ = self._canvas(tuple(tuple(f.shape[-2:]) for f in feats), f0.device)
        vis = f0.new_zeros((f0.shape[0], f0.shape[1], layout.height, layout.width))
        for f, (r, c), (h, w) in zip(feats, layout.offsets, layout.sizes):
            vis[:, :, r : r + h, c : c + w] = f
        b = q.shape[0]
        vis = self._to_pairs(vis, b)
        occ = occ.to(vis.dtype)
        lang = q[:, :, None, None].to(vis.dtype) * occ
        x = torch.cat([vis, lang, grid.to(vis.dtype).expand(b, -1, -1, -1)], dim=1)
        out = self.head(x, occupancy=occ)
        return [out[:, :, r : r + h, c : c + w] for (r, c), (h, w) in zip(layout.offsets, layout.sizes)]

    def forward(self, img: Tensor, qvec: Tensor, qlens: Tensor, canvas: bool | None = None,
                packed_lstm: bool = True, spatial=None) -> dict:
        """img (B, H, W, 3) uint8 (normalized here, in float32) or float
        already normalized; qvec (N, T) int and qlens (N,) int with N a
        multiple of B (B = 1 against N queries, or B = N), or grouped:
        qvec (B, Q, T) and qlens (B, Q), N = B·Q pairs, pair-major.
        ``canvas`` picks the canvas head for this call (default
        ``cfg.head_canvas``; per-level heads have none). ``packed_lstm=False``
        encodes the queries with the masked scan, which ``torch.export``
        traces. ``spatial``: ``img`` holds this member's rows and the
        queries are the whole group's, one per image (or Q per image)."""
        if spatial is not None:
            if self.training and self.cfg.mdl_to_use != "retina" and self.cfg.spatial_mode == "halo":
                raise NotImplementedError(
                    "halo spatial partitioning is retina-only; ssd_vgg uses the "
                    "(measured-exact) GSPMD path"
                )
            if qvec.shape[0] != img.shape[0]:
                raise ValueError(f"spatial: {qvec.shape[0]} query rows for {img.shape[0]} images")
            qvec, qlens = spatial.slice_batch(qvec), spatial.slice_batch(qlens)
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
        q = (encode_query if packed_lstm else encode_query_masked)(self.embedding, self.lstm, qvec, qlens)
        b, a = q.shape[0], self.cfg.num_anchors
        if spatial is None and b % x.shape[0]:
            raise ValueError(f"{b} queries do not divide among {x.shape[0]} images")
        use_canvas = (self.cfg.head_canvas if canvas is None else canvas) and hasattr(self, "head")
        atts, bbxs, feat_sizes = [], [], []
        with autocast:
            feats = self._features(x, spatial)
            if use_canvas:
                outs = self._canvas_head(feats, q)
            else:
                outs = [self._level_head(f, q, head) for f, head in zip(feats, self.level_heads)]
            for out in outs:
                h, w = out.shape[-2:]
                r = out.float().permute(0, 2, 3, 1).reshape(b, h * w * a, 5)
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
