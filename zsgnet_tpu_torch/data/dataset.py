"""CSV grounding dataset and a sequential evaluation loader.

The evaluation subset of ``zsgnet_tpu/data/dataset.py``: the unified CSV
schema (``img_id``, pixel ``x1 y1 x2 y2`` or a JSON ``bbox`` column,
``query``, optional ``case``), PIL-bilinear resize to ``cfg.resize_img``,
uint8 HWC images (the model normalizes them on the device), queries padded
to ``cfg.max_qlen``, and boxes as normalized [-1, 1] tlbr (y1, x1, y2, x2).

``EvalLoader`` walks a split in order and pads the last batch by wrapping,
with a ``valid`` mask marking the real rows, exactly as the JAX
``BatchLoader(shuffle=False, drop_last=False)`` does.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Iterator

import numpy as np
import pandas as pd

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data.vocab import Vocab

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image_bytes_u8(
    data: bytes, resize_hw: tuple[int, int]
) -> tuple[np.ndarray, tuple[int, int]]:
    """Encoded bytes → (HWC uint8 image resized with PIL bilinear, original (H, W))."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB")
        orig_w, orig_h = im.size
        im = im.resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8), (orig_h, orig_w)


def _load_image_u8(path: Path, resize_hw: tuple[int, int]) -> tuple[np.ndarray, tuple[int, int]]:
    """Path wrapper over ``load_image_bytes_u8``."""
    return load_image_bytes_u8(Path(path).read_bytes(), resize_hw)


def _parse_box(row: pd.Series) -> np.ndarray:
    """Pixel (x1, y1, x2, y2) from either 4 columns or a JSON 'bbox' column."""
    if "bbox" in row and isinstance(row["bbox"], str):
        vals = json.loads(row["bbox"])
    elif "bbox" in row and isinstance(row["bbox"], (list, tuple)):
        vals = row["bbox"]
    else:
        vals = [row["x1"], row["y1"], row["x2"], row["y2"]]
    return np.asarray(vals, dtype=np.float32)


def normalize_box_xyxy(box_xyxy: np.ndarray, orig_hw: tuple[int, int]) -> np.ndarray:
    """Pixel xyxy (original frame) → normalized [-1,1] tlbr (y1,x1,y2,x2)."""
    h, w = float(orig_hw[0]), float(orig_hw[1])
    x1, y1, x2, y2 = box_xyxy
    return np.asarray(
        [y1 / h * 2 - 1, x1 / w * 2 - 1, y2 / h * 2 - 1, x2 / w * 2 - 1],
        dtype=np.float32,
    )


class ImgQuDataset:
    """One split of a grounding dataset backed by a CSV file.

    ``__getitem__`` returns the reference's batch keys: ``img`` (H, W, 3
    uint8), ``qvec`` (max_qlen int32), ``qlens`` (int32), ``annot`` (4,
    normalized tlbr), ``orig_annot`` (4, pixel xyxy), ``img_size`` (2,
    original H W), ``idxs`` (int32), ``case`` (int32, -1 if none).
    """

    def __init__(self, csv_path: str | Path, image_dir: str | Path, vocab: Vocab, cfg: Config):
        self.csv_path = Path(csv_path)
        self.df = pd.read_csv(csv_path)
        if "query" not in self.df.columns:
            raise ValueError(f"{csv_path}: CSV must have a 'query' column")
        self.image_dir = Path(image_dir)
        self.vocab = vocab
        self.cfg = cfg
        self.has_case = "case" in self.df.columns

    def __len__(self) -> int:
        return len(self.df)

    def queries(self) -> list[str]:
        return [str(q) for q in self.df["query"]]

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        row = self.df.iloc[i]
        img, orig_hw = _load_image_u8(self.image_dir / str(row["img_id"]), self.cfg.resize_img)
        box_xyxy = _parse_box(row)
        ids, qlen = self.vocab.encode(str(row["query"]), self.cfg.max_qlen)
        return {
            "img": img,
            "qvec": np.asarray(ids, dtype=np.int32),
            "qlens": np.int32(qlen),
            "annot": normalize_box_xyxy(box_xyxy, orig_hw),
            "orig_annot": box_xyxy,
            "img_size": np.asarray(orig_hw, dtype=np.float32),
            "idxs": np.int32(i),
            "case": np.int32(row["case"]) if self.has_case else np.int32(-1),
        }


def collate(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class EvalLoader:
    """Batches of ``ds`` in order; the last batch wraps to ``batch_size``
    rows and its ``valid`` mask marks the real ones."""

    def __init__(self, ds: ImgQuDataset, batch_size: int):
        self.ds = ds
        self.bs = int(batch_size)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.ds)
        for start in range(0, n, self.bs):
            idxs = [i % n for i in range(start, start + self.bs)]
            batch = collate([self.ds[i] for i in idxs])
            batch["valid"] = np.arange(start, start + self.bs) < n
            yield batch
