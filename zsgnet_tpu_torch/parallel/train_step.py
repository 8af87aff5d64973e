"""Evaluation step — the eval half of ``zsgnet_tpu/parallel/train_step.py``.

One device, no mesh. ``make_compute_loss`` is the loss-variant dispatch
the train and eval steps share: the focal, multi-positive, non-softmax
loss goes through the fused match + loss (kernel K1 on CUDA, its plain
version on the CPU); every other variant goes through the eager
``ops.losses.zsg_loss``. The port always runs the flat (B, A) layout, so
``cfg.use_level_path`` and ``cfg.use_pallas`` select nothing here.

Not ported yet: the train step with the backward kernel, gradient
accumulation, EMA and data parallelism.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.ops import anchors as anchor_ops
from zsgnet_tpu_torch.ops import losses
from zsgnet_tpu_torch.ops.cuda.fused_loss import pack_anchors, zsg_loss_fused
from zsgnet_tpu_torch.train.evaluator import eval_batch
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor


def make_compute_loss(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda"
) -> Callable[..., dict[str, Tensor]]:
    """→ ``compute_loss(out, annot, sample_weight=None) -> loss dict``.
    ``sample_weight`` (B,) scales every loss term and the positive count."""
    dev = resolve_device(device)
    anchors = torch.as_tensor(anchors_cthw, dtype=torch.float32).to(dev)
    use_fused = cfg.use_focal and cfg.use_multi and not cfg.use_softmax
    packed = pack_anchors(anchors, dev) if use_fused else None

    def compute_loss(out: dict, annot: Tensor, sample_weight: Tensor | None = None):
        if use_fused:
            return zsg_loss_fused(
                out["att_out"], out["bbx_out"], packed, annot,
                lamb_reg=cfg.lamb_reg, match_thr=cfg.matching_threshold,
                neg_thr=cfg.neg_threshold, alpha=cfg.focal_alpha,
                gamma=cfg.focal_gamma, sample_weight=sample_weight,
            )
        labels, reg_t = anchor_ops.match_and_encode(
            anchors, annot, cfg.matching_threshold, cfg.neg_threshold, use_multi=cfg.use_multi
        )
        return losses.zsg_loss(
            out["att_out"], out["bbx_out"], labels, reg_t,
            lamb_reg=cfg.lamb_reg, alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
            use_focal=cfg.use_focal, use_softmax=cfg.use_softmax,
            sample_weight=sample_weight,
        )

    return compute_loss


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, Tensor]:
    """The model and loss inputs of a host batch, as tensors on ``device``.
    ``qlens`` stays on the CPU, where ``pack_padded_sequence`` reads it."""
    out = {k: torch.as_tensor(batch[k]).to(device) for k in ("img", "qvec", "annot")}
    out["qlens"] = torch.as_tensor(batch["qlens"])
    if "valid" in batch:
        out["valid"] = torch.as_tensor(batch["valid"]).to(device)
    return out


def make_eval_step(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda"
) -> Callable[[torch.nn.Module, dict], dict[str, Tensor]]:
    """→ ``run(model, batch) -> per-sample metrics`` (``iou``, ``correct``,
    ``pred_box``, ``max_pos``) plus ``loss``, the batch's validation loss
    broadcast per sample. A ``valid`` mask in the batch weights the loss,
    so wrap-padded tail rows count zero times."""
    dev = resolve_device(device)
    anchors = torch.as_tensor(anchors_cthw, dtype=torch.float32).to(dev)
    compute_loss = make_compute_loss(cfg, anchors_cthw, dev)

    @torch.inference_mode()
    def run(model: torch.nn.Module, batch: dict) -> dict[str, Tensor]:
        b = to_device(batch, dev)
        out = model(b["img"], b["qvec"], b["qlens"])
        annot = b["annot"].float()
        w = b["valid"].float() if "valid" in b else None
        ev = eval_batch(out["att_out"], out["bbx_out"], anchors, annot, cfg.acc_iou_threshold)
        ls = compute_loss(out, annot, sample_weight=w)
        ev["loss"] = ls["total"].expand_as(ev["iou"])
        return ev

    return run
