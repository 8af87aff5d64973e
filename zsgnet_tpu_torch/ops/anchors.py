"""Anchor pyramid and matching — torch port of ``zsgnet_tpu/ops/anchors.py``.

The pyramid is built once in NumPy from the fixed input size and has the
JAX package's ordering: level-major, then row-major cells, then the
anchors of a cell (scale-major, ratio-minor). With 300² input and P3–P7 it
holds 38²+19²+10²+5²+3² = 1939 cells × 9 = 17451 anchors.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from zsgnet_tpu_torch.ops import boxes as box_ops

Tensor = torch.Tensor

# FPN strides for P3..P7 (retina mode).
RETINA_STRIDES = (8, 16, 32, 64, 128)


def feature_map_sizes(
    img_size: Sequence[int], strides: Sequence[int] = RETINA_STRIDES
) -> tuple[tuple[int, int], ...]:
    """(H_i, W_i) per pyramid level: ceil-division, as stride-2 convs with
    padding 1 give (300² → 38, 19, 10, 5, 3)."""
    h, w = int(img_size[0]), int(img_size[1])
    return tuple((math.ceil(h / s), math.ceil(w / s)) for s in strides)


def create_grid(size: Sequence[int], flatten: bool = True) -> np.ndarray:
    """Normalized (y, x) cell centers of one (H, W) feature map: (H*W, 2),
    or (H, W, 2) when ``flatten`` is False."""
    h, w = int(size[0]), int(size[1])
    ys = (np.arange(h, dtype=np.float32) + 0.5) * (2.0 / h) - 1.0
    xs = (np.arange(w, dtype=np.float32) + 0.5) * (2.0 / w) - 1.0
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1)
    return grid.reshape(-1, 2) if flatten else grid


def create_anchors(
    scales: Sequence[float],
    ratios: Sequence[float],
    feat_sizes: Sequence[tuple[int, int]],
) -> np.ndarray:
    """The full (ΣHW·A, 4) float32 cthw anchor pyramid. Per level the base
    extent is one cell (2/H × 2/W); each anchor is (base_h·s·√r, base_w·s/√r)."""
    per_level = []
    for (h, w) in feat_sizes:
        grid = create_grid((h, w), flatten=False)
        base_h, base_w = 2.0 / h, 2.0 / w
        sizes = []
        for s in scales:
            for r in ratios:
                sizes.append((base_h * s * math.sqrt(r), base_w * s / math.sqrt(r)))
        sizes_arr = np.asarray(sizes, dtype=np.float32)
        a = sizes_arr.shape[0]
        centers = np.broadcast_to(grid[:, :, None, :], (h, w, a, 2))
        extents = np.broadcast_to(sizes_arr[None, None, :, :], (h, w, a, 2))
        per_level.append(np.concatenate([centers, extents], axis=-1).reshape(-1, 4))
    return np.concatenate(per_level, axis=0).astype(np.float32)


def simple_match_anchors(
    anchors_cthw: Tensor,
    gt_tlbr: Tensor,
    match_thr: float = 0.5,
    neg_thr: float = 0.4,
    force_best: bool = True,
) -> Tensor:
    """Dense labels (..., A) int32: +1 if IoU ≥ match_thr, 0 if IoU < neg_thr,
    -1 (ignore) in between. ``force_best`` promotes each row's highest-IoU
    anchor to positive; ``torch.argmax`` takes the first of tied maxima,
    the same tie-break as ``jnp.argmax``."""
    anchors_tlbr = box_ops.cthw2tlbr(anchors_cthw)
    iou = box_ops.iou_pairwise(gt_tlbr[..., None, :], anchors_tlbr)[..., 0, :]
    one, zero, ign = (torch.tensor(v, dtype=torch.int32, device=iou.device) for v in (1, 0, -1))
    labels = torch.where(iou >= match_thr, one, torch.where(iou < neg_thr, zero, ign))
    if force_best:
        best = iou.argmax(dim=-1, keepdim=True)
        labels = labels.scatter(-1, best, 1)
    return labels


def match_and_encode(
    anchors_cthw: Tensor,
    gt_tlbr: Tensor,
    match_thr: float = 0.5,
    neg_thr: float = 0.4,
    use_multi: bool = True,
) -> tuple[Tensor, Tensor]:
    """anchors (A, 4) cthw, gt (B, 4) tlbr → labels (B, A) int32 and
    reg_targets (B, A, 4) float32 (defined at every anchor).

    ``use_multi=False`` is the best-anchor-only variant: only the argmax
    anchor is positive, and other anchors above the match threshold are
    ignored rather than supervised."""
    labels = simple_match_anchors(anchors_cthw, gt_tlbr, match_thr, neg_thr)
    if not use_multi:
        anchors_tlbr = box_ops.cthw2tlbr(anchors_cthw)
        iou = box_ops.iou_pairwise(gt_tlbr[..., None, :], anchors_tlbr)[..., 0, :]
        best = iou.argmax(dim=-1, keepdim=True)
        labels = torch.where(labels == 1, torch.full_like(labels, -1), labels)
        labels = labels.scatter(-1, best, 1)
    reg_targets = box_ops.bbox_to_reg_params(anchors_cthw[None, :, :], gt_tlbr[:, None, :])
    return labels, reg_targets
