"""Plain PyTorch reference of ZSGNet's training objective, its top-box
decode and Adam.

Boxes are normalized to [-1, 1]: ``tlbr`` is (y1, x1, y2, x2), ``cthw``
(cy, cx, h, w). An anchor is positive where its IoU with the query's box
is at least ``matching_threshold`` or where it is the row's best anchor
(the first of tied maxima), negative below ``neg_threshold``, ignored in
between. The loss is the sigmoid focal loss (α, γ) over positives and
negatives plus ``lamb_reg`` times the smooth-L1 (β = 1/9) of the
variance-scaled box deltas (0.1 for the centre, 0.2 for log-sizes) at the
positives, both summed over the batch and divided by the positive count
(at least 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

STD_CENTER, STD_SIZE = 0.1, 0.2
BETA = 1.0 / 9.0


def cthw_to_tlbr(b: Tensor) -> Tensor:
    return torch.cat([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], dim=-1)


def iou_with(gt: Tensor, anchors_tlbr: Tensor) -> Tensor:
    """gt (B, 4) tlbr, anchors (A, 4) tlbr → (B, A) IoU."""
    g, a = gt[:, None, :], anchors_tlbr[None]
    inter = (torch.minimum(g[..., 2:], a[..., 2:]) - torch.maximum(g[..., :2], a[..., :2])).clamp(min=0).prod(-1)
    area = lambda b: (b[..., 2:] - b[..., :2]).clamp(min=0).prod(-1)  # noqa: E731
    union = area(g) + area(a) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def labels(cfg: dict, anchors_cthw: Tensor, gt: Tensor) -> tuple[Tensor, Tensor]:
    """(positive, counted) boolean (B, A) masks."""
    iou = iou_with(gt, cthw_to_tlbr(anchors_cthw))
    best = torch.zeros_like(iou, dtype=torch.bool)
    best[torch.arange(iou.shape[0]), iou.argmax(dim=1)] = True
    pos = (iou >= cfg["matching_threshold"]) | best
    return pos, pos | (iou < cfg["neg_threshold"])


def encode(anchors_cthw: Tensor, gt: Tensor) -> Tensor:
    """(B, A, 4) deltas that take each anchor to its row's box."""
    t = torch.cat([(gt[:, 2:] + gt[:, :2]) / 2, gt[:, 2:] - gt[:, :2]], dim=-1)[:, None]
    a = anchors_cthw[None]
    return torch.cat([(t[..., :2] - a[..., :2]) / (a[..., 2:] * STD_CENTER),
                      torch.log(t[..., 2:] / a[..., 2:]) / STD_SIZE], dim=-1)


def loss(cfg: dict, att: Tensor, bbx: Tensor, anchors_cthw: Tensor, gt: Tensor, group=None) -> Tensor:
    """The batch's total loss (a 0-d tensor). With ``group`` the positive
    count is every rank's, and the value is this rank's share of the whole
    batch's loss (the shares sum to it)."""
    pos, counted = labels(cfg, anchors_cthw, gt)
    posf = pos.to(att.dtype)
    alpha, gamma = cfg.get("focal_alpha", 0.25), cfg.get("focal_gamma", 2.0)
    ce = F.binary_cross_entropy_with_logits(att, posf, reduction="none")
    p = torch.sigmoid(att)
    p_t = torch.where(pos, p, 1 - p)
    alpha_t = torch.where(pos, torch.full_like(p, alpha), torch.full_like(p, 1 - alpha))
    focal = alpha_t * (1 - p_t) ** gamma * ce
    d = (bbx - encode(anchors_cthw, gt)).abs()
    sl1 = torch.where(d < BETA, 0.5 * d * d / BETA, d - 0.5 * BETA).sum(-1)
    n_pos = posf.sum().detach()
    if group is not None:
        torch.distributed.all_reduce(n_pos, group=group)
    n_pos = n_pos.clamp(min=1)
    return (focal * counted).sum() / n_pos + cfg.get("lamb_reg", 1.0) * (sl1 * posf).sum() / n_pos


def decode_top(att: Tensor, bbx: Tensor, anchors_cthw: Tensor) -> tuple[Tensor, Tensor]:
    """Every row's best anchor (first of ties) → (its index (N,), its box
    (N, 4) tlbr clipped to the frame)."""
    idx = att.argmax(dim=1)
    return idx, decode(anchors_cthw[idx], bbx[torch.arange(att.shape[0]), idx])


def decode(anchors_cthw: Tensor, deltas: Tensor) -> Tensor:
    """Deltas at anchors (broadcast) → tlbr boxes clipped to [-1, 1]; the
    log-size deltas are clamped to ±8 (after the 0.2 scale) before exp."""
    centre = anchors_cthw[..., :2] + deltas[..., :2] * STD_CENTER * anchors_cthw[..., 2:]
    size = anchors_cthw[..., 2:] * torch.exp((deltas[..., 2:] * STD_SIZE).clamp(-8, 8))
    return cthw_to_tlbr(torch.cat([centre, size], dim=-1)).clamp(-1, 1)


class Adam:
    """Adam (β 0.9 / 0.999, ε 1e-8, bias-corrected) over named tensors."""

    def __init__(self, lr: float, betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t = 0
        self.m: dict[str, Tensor] = {}
        self.v: dict[str, Tensor] = {}

    @torch.no_grad()
    def step(self, params: dict[str, Tensor], grads: dict[str, Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, g in grads.items():
            m = self.m[n] = self.b1 * self.m.get(n, torch.zeros_like(g)) + (1 - self.b1) * g
            v = self.v[n] = self.b2 * self.v.get(n, torch.zeros_like(g)) + (1 - self.b2) * g * g
            params[n] -= self.lr * (m / c1) / ((v / c2).sqrt() + self.eps)
