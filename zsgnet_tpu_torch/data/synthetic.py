"""Synthetic grounding dataset — a copy of ``zsgnet_tpu/data/synthetic.py``.

Writes a real on-disk dataset in the unified CSV schema (images +
``csv_dir/{train,val,test}.csv``): 2–4 colored rectangles/ellipses on a
noise background per image, and a query naming one of them by color and
shape. The same seed gives the same files as the JAX package's generator.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

COLORS = {
    "red": (220, 40, 40),
    "green": (40, 200, 60),
    "blue": (50, 80, 230),
    "yellow": (230, 220, 50),
    "purple": (160, 60, 200),
    "orange": (240, 140, 30),
}
SHAPES = ("box", "ellipse")


def _draw(img: np.ndarray, shape: str, color: tuple[int, int, int], box: tuple[int, int, int, int]) -> None:
    y1, x1, y2, x2 = box
    h, w = y2 - y1, x2 - x1
    if shape == "box":
        img[y1:y2, x1:x2] = color
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = (h - 1) / 2, (w - 1) / 2
        mask = ((yy - cy) / max(cy, 1)) ** 2 + ((xx - cx) / max(cx, 1)) ** 2 <= 1.0
        region = img[y1:y2, x1:x2]
        region[mask] = color
        img[y1:y2, x1:x2] = region


def generate(
    root: str | Path,
    n_train: int = 64,
    n_val: int = 16,
    n_test: int = 16,
    img_size: int = 128,
    seed: int = 0,
    fmt: str = "png",
    all_objects: bool = False,
) -> Path:
    """Write the dataset under ``<root>/synthetic/`` and return that path.

    ``all_objects=True`` emits one CSV row per drawn object (2–4 queries
    per image) instead of one.
    """
    from PIL import Image

    root = Path(root) / "synthetic"
    img_dir = root / "images"
    csv_dir = root / "csv_dir"
    img_dir.mkdir(parents=True, exist_ok=True)
    csv_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    color_names = list(COLORS)

    counters = {"train": n_train, "val": n_val, "test": n_test}
    idx = 0
    for split, n in counters.items():
        rows = []
        for _ in range(n):
            img = rng.integers(0, 60, size=(img_size, img_size, 3)).astype(np.uint8)
            n_obj = int(rng.integers(2, 5))
            chosen = rng.choice(len(color_names), size=n_obj, replace=False)
            boxes = []
            for ci in chosen:
                shape = SHAPES[int(rng.integers(0, 2))]
                s = int(rng.integers(img_size // 6, img_size // 2))
                y1 = int(rng.integers(0, img_size - s))
                x1 = int(rng.integers(0, img_size - s))
                box = (y1, x1, y1 + s, x1 + s)
                _draw(img, shape, COLORS[color_names[ci]], box)
                boxes.append((color_names[ci], shape, box))
            fname = f"{split}_{idx:05d}.{fmt}"
            Image.fromarray(img).save(img_dir / fname, quality=90)
            targets = boxes if all_objects else [boxes[int(rng.integers(0, n_obj))]]
            for cname, shape, (y1, x1, y2, x2) in targets:
                rows.append(
                    {
                        "img_id": fname,
                        "x1": x1, "y1": y1, "x2": x2, "y2": y2,
                        "query": f"the {cname} {shape}",
                        "case": -1,
                    }
                )
            idx += 1
        pd.DataFrame(rows).to_csv(csv_dir / f"{split}.csv", index=False)
    return root
