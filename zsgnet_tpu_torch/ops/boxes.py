"""Box geometry in normalized coordinates — torch port of ``zsgnet_tpu/ops/boxes.py``.

``tlbr``: (y_min, x_min, y_max, x_max); ``cthw``: (cy, cx, h, w).
Coordinates are normalized to [-1, 1]. All math is float32 whatever the
input dtype, and every function broadcasts over leading dimensions.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Regression deltas are variance-scaled: center deltas by 0.1 · anchor
# size, log-size deltas by 0.2 (the SSD/RetinaNet convention).
STD_CENTER = 0.1
STD_SIZE = 0.2


def tlbr2cthw(boxes: Tensor) -> Tensor:
    """(..., 4) tlbr → (..., 4) cthw."""
    boxes = boxes.float()
    center = (boxes[..., :2] + boxes[..., 2:]) * 0.5
    size = boxes[..., 2:] - boxes[..., :2]
    return torch.cat([center, size], dim=-1)


def cthw2tlbr(boxes: Tensor) -> Tensor:
    """(..., 4) cthw → (..., 4) tlbr."""
    boxes = boxes.float()
    half = boxes[..., 2:] * 0.5
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def box_area_tlbr(boxes: Tensor) -> Tensor:
    """(..., 4) tlbr → (...,) area, clamped at 0 for degenerate boxes."""
    boxes = boxes.float()
    hw = (boxes[..., 2:] - boxes[..., :2]).clamp(min=0.0)
    return hw[..., 0] * hw[..., 1]


def iou_pairwise(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """(..., N, 4) tlbr × (..., M, 4) tlbr → (..., N, M) IoU."""
    b1 = boxes1.float()[..., :, None, :]
    b2 = boxes2.float()[..., None, :, :]
    tl = torch.maximum(b1[..., :2], b2[..., :2])
    br = torch.minimum(b1[..., 2:], b2[..., 2:])
    inter_hw = (br - tl).clamp(min=0.0)
    inter = inter_hw[..., 0] * inter_hw[..., 1]
    area1 = box_area_tlbr(boxes1)[..., :, None]
    area2 = box_area_tlbr(boxes2)[..., None, :]
    union = area1 + area2 - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def iou_aligned(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Elementwise IoU of aligned box arrays: (..., 4) × (..., 4) → (...,)."""
    b1, b2 = boxes1.float(), boxes2.float()
    tl = torch.maximum(b1[..., :2], b2[..., :2])
    br = torch.minimum(b1[..., 2:], b2[..., 2:])
    inter_hw = (br - tl).clamp(min=0.0)
    inter = inter_hw[..., 0] * inter_hw[..., 1]
    union = box_area_tlbr(b1) + box_area_tlbr(b2) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def bbox_to_reg_params(anchors_cthw: Tensor, boxes_tlbr: Tensor) -> Tensor:
    """Encode tlbr target boxes as variance-scaled deltas against cthw anchors
    (broadcastable) → (..., 4) (dcy, dcx, log dh, log dw)."""
    a = anchors_cthw.float()
    t = tlbr2cthw(boxes_tlbr)
    a_size = a[..., 2:].clamp(min=1e-8)
    d_center = (t[..., :2] - a[..., :2]) / (a_size * STD_CENTER)
    d_size = torch.log((t[..., 2:] / a_size).clamp(min=1e-8)) / STD_SIZE
    return torch.cat([d_center, d_size], dim=-1)


def reg_params_to_bbox(anchors_cthw: Tensor, reg: Tensor) -> Tensor:
    """Decode deltas into tlbr boxes; the inverse of :func:`bbox_to_reg_params`.
    Size deltas are clamped before exp so untrained logits give finite boxes."""
    a = anchors_cthw.float()
    reg = reg.float()
    center = a[..., :2] + reg[..., :2] * STD_CENTER * a[..., 2:]
    d_size = (reg[..., 2:] * STD_SIZE).clamp(-8.0, 8.0)
    size = a[..., 2:] * torch.exp(d_size)
    return cthw2tlbr(torch.cat([center, size], dim=-1))


def clip_boxes(boxes_tlbr: Tensor, low: float = -1.0, high: float = 1.0) -> Tensor:
    """Clamp tlbr boxes to the normalized image frame."""
    return boxes_tlbr.clamp(low, high)


def scale_boxes_to_pixels(boxes_tlbr_norm: Tensor, img_hw: Tensor) -> Tensor:
    """Normalized [-1,1] tlbr boxes → pixel tlbr for (..., 2) float (H, W)."""
    hw = img_hw.float()
    scale = torch.cat([hw, hw], dim=-1) * 0.5
    return (boxes_tlbr_norm + 1.0) * scale
