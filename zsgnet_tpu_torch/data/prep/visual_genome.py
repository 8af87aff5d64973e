"""Visual Genome region descriptions → unified CSV.

Consumes the standard ``region_descriptions.json`` (list of images, each
with ``regions`` carrying x/y/width/height + phrase) and optionally the
standard ``objects.json`` (per-image object instances with ``names`` +
WordNet ``synsets``), which drives the zero-shot split builder: it yields
the word→category map AND the per-image object lists (an ``objects``
column of JSON name-lists) that cases 2/3 use to detect same-category /
similar-category distractors. Regions are the grounding targets, matching
the paper's VG usage.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import pandas as pd


def build_category_map(objects_json: Path) -> tuple[dict[str, str], dict[int, list[str]]]:
    """``objects.json`` → (word→category, image_id→[object names]).

    Category = the object's WordNet synset head (``clock.n.01`` →
    ``clock``); every word of every name maps to it (so "alarm clock" maps
    both tokens). Objects without synsets fall back to their first name.
    The per-image name lists feed the case-2/3 distractor check.
    """
    with open(objects_json) as f:
        data = json.load(f)
    categories: dict[str, str] = {}
    img_objects: dict[int, list[str]] = {}
    for img in data:
        img_id = int(img.get("image_id", img.get("id")))
        names: list[str] = []
        for obj in img.get("objects", []):
            obj_names = [str(n).strip().lower() for n in obj.get("names", []) if str(n).strip()]
            names.extend(obj_names)
            synsets = obj.get("synsets") or []
            cat = synsets[0].split(".")[0] if synsets else (obj_names[0] if obj_names else None)
            if cat is None:
                continue
            for name in obj_names:
                for w in name.split():
                    categories.setdefault(w, cat)
        img_objects[img_id] = sorted(set(names))
    return categories, img_objects


def convert(
    regions_json: Path, out: Path, val_frac: float = 0.1, test_frac: float = 0.1,
    seed: int = 0, min_size: float = 16.0, objects_json: Path | None = None,
) -> None:
    with open(regions_json) as f:
        data = json.load(f)

    img_objects: dict[int, list[str]] = {}
    if objects_json is not None:
        categories, img_objects = build_category_map(objects_json)
        out.mkdir(parents=True, exist_ok=True)
        (out / "categories.json").write_text(json.dumps(categories, indent=0))
        print(f"categories.json: {len(categories)} words → {len(set(categories.values()))} categories")

    rows = []
    for img in data:
        img_id = img.get("id", img.get("image_id"))
        for r in img.get("regions", []):
            w, h = float(r["width"]), float(r["height"])
            if w < min_size or h < min_size:
                continue
            phrase = str(r.get("phrase", "")).strip().lower()
            if not phrase:
                continue
            x, y = float(r["x"]), float(r["y"])
            row = {
                "img_id": f"{img_id}.jpg",
                "x1": x, "y1": y, "x2": x + w, "y2": y + h,
                "query": phrase,
            }
            if img_objects:  # case-2/3 distractor inputs (zero_shot_splits)
                row["objects"] = json.dumps(img_objects.get(int(img_id), []))
            rows.append(row)

    rng = np.random.default_rng(seed)
    img_ids = sorted({r["img_id"] for r in rows})
    perm = rng.permutation(len(img_ids))
    n_val = int(len(img_ids) * val_frac)
    n_test = int(len(img_ids) * test_frac)
    val_set = {img_ids[i] for i in perm[:n_val]}
    test_set = {img_ids[i] for i in perm[n_val : n_val + n_test]}

    out_csv = out / "csv_dir"
    out_csv.mkdir(parents=True, exist_ok=True)
    splits = {"train": [], "val": [], "test": []}
    for r in rows:
        split = "val" if r["img_id"] in val_set else "test" if r["img_id"] in test_set else "train"
        splits[split].append(r)
    for split, rs in splits.items():
        pd.DataFrame(rs).to_csv(out_csv / f"{split}.csv", index=False)
        print(f"{split}: {len(rs)} regions")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--regions", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--val-frac", type=float, default=0.1)
    ap.add_argument("--test-frac", type=float, default=0.1)
    ap.add_argument("--objects", type=Path, default=None,
                    help="objects.json → categories.json + per-row objects column")
    a = ap.parse_args()
    convert(a.regions, a.out, a.val_frac, a.test_frac, objects_json=a.objects)


if __name__ == "__main__":
    main()
