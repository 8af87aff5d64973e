"""Grounding evaluator — torch port of ``zsgnet_tpu/train/evaluator.py``.

Argmax over anchor scores → decode that anchor's box → IoU with the gt →
accuracy at a threshold; the ``MaxPos`` diagnostic (would the highest-IoU
anchor itself decode to a hit?); per-sample records for the zero-shot case
breakdown and prediction dumps. ``eval_batch`` runs on the device;
``Evaluator`` accumulates on the host in NumPy.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from zsgnet_tpu_torch.ops import boxes as box_ops

Tensor = torch.Tensor


def decode_best_box(scores: Tensor, bbx_reg: Tensor, anchors_cthw: Tensor) -> Tensor:
    """scores (B, A), bbx_reg (B, A, 4), anchors (A, 4) → (B, 4) clipped tlbr
    of each row's argmax anchor (the first of tied maxima)."""
    best = scores.argmax(dim=-1)
    rows = torch.arange(scores.shape[0], device=scores.device)
    sel_anchor = anchors_cthw.float()[best]
    sel_reg = bbx_reg.float()[rows, best]
    return box_ops.clip_boxes(box_ops.reg_params_to_bbox(sel_anchor, sel_reg))


def eval_batch(
    att_logits: Tensor, bbx_reg: Tensor, anchors_cthw: Tensor, gt_tlbr: Tensor,
    iou_thr: float = 0.5,
) -> dict[str, Tensor]:
    """Per-sample ``iou`` (B,), ``correct`` (B,) {0, 1}, ``pred_box`` (B, 4)
    tlbr and ``max_pos`` (B,) {0, 1}."""
    pred_box = decode_best_box(att_logits, bbx_reg, anchors_cthw)
    iou = box_ops.iou_aligned(pred_box, gt_tlbr)
    correct = (iou > iou_thr).float()

    anchors_tlbr = box_ops.cthw2tlbr(anchors_cthw)
    anchor_iou = box_ops.iou_pairwise(gt_tlbr[:, None, :], anchors_tlbr)[:, 0, :]
    o_box = decode_best_box(anchor_iou, bbx_reg, anchors_cthw)
    max_pos = (box_ops.iou_aligned(o_box, gt_tlbr) > iou_thr).float()
    return {"iou": iou, "correct": correct, "pred_box": pred_box, "max_pos": max_pos}


def _np(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Evaluator:
    """Host-side accumulator; ``summarize()`` returns 'Acc', 'MaxPos',
    'MeanIoU', 'num_samples', the valid-count-weighted 'loss' and
    'Acc_case_<k>' per zero-shot case."""

    def __init__(self, iou_thr: float = 0.5):
        self.iou_thr = iou_thr
        self.reset()

    def reset(self) -> None:
        self.correct: list[np.ndarray] = []
        self.max_pos: list[np.ndarray] = []
        self.iou: list[np.ndarray] = []
        self.cases: list[np.ndarray] = []
        self.ids: list[np.ndarray] = []
        self.pred_boxes: list[np.ndarray] = []
        self.losses: list[tuple[float, int]] = []  # (batch loss, valid count)

    def update(
        self,
        batch_metrics: dict[str, Any],
        cases: np.ndarray | None = None,
        ids: np.ndarray | None = None,
        valid: np.ndarray | None = None,
    ) -> None:
        """valid: bool mask of the real rows of a wrap-padded tail batch."""
        correct = _np(batch_metrics["correct"])
        n = correct.shape[0]
        valid = np.ones(n, dtype=bool) if valid is None else np.asarray(valid, dtype=bool)
        self.correct.append(correct[valid])
        self.max_pos.append(_np(batch_metrics["max_pos"])[valid])
        self.iou.append(_np(batch_metrics["iou"])[valid])
        self.pred_boxes.append(_np(batch_metrics["pred_box"])[valid])
        if cases is not None:
            self.cases.append(np.asarray(cases)[valid])
        if ids is not None:
            self.ids.append(np.asarray(ids)[valid])
        if "loss" in batch_metrics:
            self.losses.append(
                (float(_np(batch_metrics["loss"]).reshape(-1)[0]), int(valid.sum()))
            )

    def summarize(self) -> dict[str, float]:
        if not self.correct:
            return {}
        correct = np.concatenate(self.correct)
        out = {
            "Acc": float(correct.mean()) if correct.size else 0.0,
            "MaxPos": float(np.concatenate(self.max_pos).mean()),
            "MeanIoU": float(np.concatenate(self.iou).mean()),
            "num_samples": float(correct.size),
        }
        if self.losses:
            vals = np.array([v for v, _ in self.losses])
            wts = np.array([n for _, n in self.losses], dtype=np.float64)
            out["loss"] = float((vals * wts).sum() / max(wts.sum(), 1.0))
        if self.cases:
            cases = np.concatenate(self.cases)
            for c in sorted(set(int(x) for x in cases if x >= 0)):
                m = cases == c
                out[f"Acc_case_{c}"] = float(correct[m].mean()) if m.any() else 0.0
        return out

    def dump_predictions(self, path: str) -> None:
        """One JSON line per sample: id, pred_box, iou, correct."""
        ids = np.concatenate(self.ids) if self.ids else None
        boxes_arr = np.concatenate(self.pred_boxes)
        iou = np.concatenate(self.iou)
        correct = np.concatenate(self.correct)
        with open(path, "w") as f:
            for i in range(len(iou)):
                rec = {
                    "id": int(ids[i]) if ids is not None else i,
                    "pred_box": [float(v) for v in boxes_arr[i]],
                    "iou": float(iou[i]),
                    "correct": bool(correct[i]),
                }
                f.write(json.dumps(rec) + "\n")
