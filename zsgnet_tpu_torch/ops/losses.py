"""Grounding losses — torch port of ``zsgnet_tpu/ops/losses.py``.

The eager version of every loss variant the reference gates by config:
sigmoid focal (``use_focal``) or plain BCE, softmax over anchors
(``use_softmax``), multi-positive or best-anchor supervision (through the
labels from ``ops.anchors.match_and_encode``). Every reduction is a masked
dense sum in float32. This module is the oracle that the fused kernel in
``ops/cuda/fused_loss.py`` is tested against.
"""

from __future__ import annotations

import torch

from zsgnet_tpu_torch.parallel.mesh import all_reduce_

Tensor = torch.Tensor


def sigmoid_focal_loss(
    logits: Tensor, targets: Tensor, alpha: float = 0.25, gamma: float = 2.0
) -> Tensor:
    """Elementwise sigmoid focal loss (Lin et al. 2017), float32, targets in
    {0, 1}, with the stable logit-space BCE max(x,0) - x·t + log1p(exp(-|x|))."""
    x = logits.float()
    t = targets.float()
    bce = x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    p = torch.sigmoid(x)
    p_t = p * t + (1.0 - p) * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * bce


def bce_loss(logits: Tensor, targets: Tensor) -> Tensor:
    """Plain stable sigmoid BCE, elementwise, float32 (``use_focal=False``)."""
    x = logits.float()
    t = targets.float()
    return x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def smooth_l1(pred: Tensor, target: Tensor, beta: float = 1.0 / 9.0) -> Tensor:
    """Elementwise smooth-L1 (Huber) with the RetinaNet beta of 1/9, float32."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def zsg_loss(
    att_logits: Tensor,
    bbx_reg: Tensor,
    labels: Tensor,
    reg_targets: Tensor,
    *,
    lamb_reg: float = 1.0,
    alpha: float = 0.25,
    gamma: float = 2.0,
    use_focal: bool = True,
    use_softmax: bool = False,
    sample_weight: Tensor | None = None,
    group=None,
) -> dict[str, Tensor]:
    """Total grounding loss over one batch.

    att_logits (B, A), bbx_reg (B, A, 4), labels (B, A) int (+1/0/-1),
    reg_targets (B, A, 4). Classification is focal (or BCE) over the
    non-ignored anchors divided by the positive count, or with
    ``use_softmax`` a softmax cross-entropy over anchors against the
    uniform distribution on positives. Regression is smooth-L1 over
    positives divided by the positive count, which is clamped to ≥ 1.

    ``sample_weight`` (B,) scales every term and the positive count; a 0
    removes the sample (eval tail pads). Returns total, cls_ls, box_ls and
    num_pos (the unclamped weighted count).

    ``group`` (a process group, as the JAX ``axis_name``): this rank holds
    one shard of the batch, and the positive count and the batch size that
    normalize it are summed over the group's ranks. The values are then
    this shard's partials of the global loss, which sum over the ranks to
    the loss of the whole batch; ``num_pos`` stays the local count.
    """
    pos = (labels == 1).float()
    valid = (labels != -1).float()
    if sample_weight is not None:
        w = sample_weight.float()[:, None]
        pos_w = pos * w
        valid = valid * w
        global_bs = w.sum()
    else:
        pos_w = pos
        global_bs = torch.tensor(float(att_logits.shape[0]), device=att_logits.device)
    num_pos_local = pos_w.sum()
    if group is not None:
        both = all_reduce_(torch.stack([num_pos_local, global_bs.float()]).detach(), group)
        num_pos, global_bs = both[0].clamp(min=1.0), both[1]
    else:
        num_pos = num_pos_local.clamp(min=1.0)

    if use_softmax:
        logits32 = att_logits.float()
        logz = torch.logsumexp(
            torch.where(valid > 0, logits32, torch.full_like(logits32, -1e9)),
            dim=-1, keepdim=True,
        )
        logp = logits32 - logz
        tgt = pos / pos.sum(dim=-1, keepdim=True).clamp(min=1.0)
        cls_ls = -(tgt * logp * valid).sum() / global_bs
    else:
        elem = (
            sigmoid_focal_loss(att_logits, pos, alpha, gamma)
            if use_focal
            else bce_loss(att_logits, pos)
        )
        cls_ls = (elem * valid).sum() / num_pos

    reg_elem = smooth_l1(bbx_reg, reg_targets)
    box_ls = (reg_elem * pos_w[..., None]).sum() / num_pos

    return {
        "total": cls_ls + lamb_reg * box_ls,
        "cls_ls": cls_ls,
        "box_ls": box_ls,
        "num_pos": num_pos_local,
    }
