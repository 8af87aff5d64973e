"""Single-shot grounding inference — torch port of the core of
``zsgnet_tpu/predict.py``.

``Grounder`` holds a model built from ``cfg``, a vocab and a port
``state_dict``; ``ground(images, queries)`` pads each chunk of requests to
``batch_size``, runs the forward pass, decodes each row's top-scored
anchor (flat argmax, first of ties) and returns the box with
``sigmoid(score)``.

Not ported yet: ``from_checkpoint``, shape buckets, the canvas head, int8,
open-vocabulary slots, ``ground_image`` and the serving daemon.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data.dataset import _load_image_u8
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for
from zsgnet_tpu_torch.train.evaluator import decode_best_box
from zsgnet_tpu_torch.utils.backend import resolve_device


def prep_chunk(cfg: Config, vocab: Vocab, bs: int, images: list, queries: list):
    """Pad one request chunk to ``bs`` rows: (imgs u8, qvec, qlens, orig
    sizes, real count). Pad rows get ``qlens`` 1, since packed sequences
    refuse length 0."""
    h, w = cfg.resize_img
    k = len(images)
    imgs = np.zeros((bs, h, w, 3), np.uint8)
    sizes = np.ones((bs, 2), np.float32)
    for j, im in enumerate(images):
        if isinstance(im, np.ndarray):
            arr = im.astype(np.uint8)
            if arr.shape[:2] != (h, w):
                raise ValueError("array inputs must be pre-resized")
            imgs[j], sizes[j] = arr, (arr.shape[0], arr.shape[1])
        else:
            imgs[j], orig_hw = _load_image_u8(Path(im), (h, w))
            sizes[j] = orig_hw
    qvec = np.zeros((bs, cfg.max_qlen), np.int32)
    qlens = np.ones((bs,), np.int32)
    for j, q in enumerate(queries):
        ids, ln = vocab.encode(q, cfg.max_qlen)
        qvec[j], qlens[j] = ids, ln
    return imgs, qvec, qlens, sizes, k


def chunk_results(boxes, scores, sizes, k: int) -> list[dict]:
    """One padded chunk's output → per-request dicts (normalized tlbr,
    original-pixel xyxy, score)."""
    boxes = np.asarray(boxes)[:k]
    scores = np.asarray(scores)[:k]
    out: list[dict] = []
    for j in range(k):
        oh, ow = sizes[j]
        y1, x1, y2, x2 = boxes[j]
        out.append(
            {
                "box_norm": [float(v) for v in boxes[j]],
                "box_xyxy": [
                    float((x1 + 1) * ow / 2), float((y1 + 1) * oh / 2),
                    float((x2 + 1) * ow / 2), float((y2 + 1) * oh / 2),
                ],
                "score": float(scores[j]),
            }
        )
    return out


class Grounder:
    """Load-once, call-many grounding predictor."""

    def __init__(
        self, cfg: Config, vocab: Vocab, state_dict: dict[str, torch.Tensor],
        batch_size: int = 8, device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = vocab
        self.bs = int(batch_size)
        self.model = ZSGNet(cfg, len(vocab))
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.anchors = torch.as_tensor(anchor_pyramid_for(cfg)).to(self.device)

    @torch.inference_mode()
    def _infer(self, imgs: np.ndarray, qvec: np.ndarray, qlens: np.ndarray):
        out = self.model(
            torch.from_numpy(imgs).to(self.device),
            torch.from_numpy(qvec).to(self.device),
            torch.from_numpy(qlens),
        )
        att = out["att_out"]
        box = decode_best_box(att, out["bbx_out"], self.anchors)
        return box.cpu().numpy(), torch.sigmoid(att.max(dim=-1).values).cpu().numpy()

    def ground(self, images: list[str | Path | np.ndarray], queries: list[str]) -> list[dict]:
        """→ per pair: {"box_xyxy": pixel [x1,y1,x2,y2], "score": float,
        "box_norm": normalized tlbr}. Images are paths or HWC uint8 arrays
        already resized to ``cfg.resize_img``."""
        if len(images) != len(queries):
            raise ValueError("images and queries must pair up")
        out: list[dict] = []
        for start in range(0, len(images), self.bs):
            imgs, qvec, qlens, sizes, k = prep_chunk(
                self.cfg, self.vocab, self.bs,
                images[start : start + self.bs], queries[start : start + self.bs],
            )
            boxes, scores = self._infer(imgs, qvec, qlens)
            out.extend(chunk_results(boxes, scores, sizes, k))
        return out
