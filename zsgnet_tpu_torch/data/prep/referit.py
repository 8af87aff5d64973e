"""ReferIt / RefClef → unified CSV.

Consumes the standard `refer` toolkit distribution (licheng Yu's
refer_python): ``refs(berkeley).p`` (or ``refs(unc).p``) pickles plus
``instances.json`` (COCO-format boxes). Each referring expression becomes
one row; the gt box is the referred instance's bbox (xywh → xyxy).

Split conventions follow the toolkit: berkeley splits carry
``train``/``val``/``test``; unc splits additionally carry ``testA``/
``testB`` (people / non-people in RefCOCO; testA/B/C in RefClef-unc).
Sub-test splits are preserved as their OWN CSVs (``testA.csv`` …) so the
reference's per-split evaluation protocol survives, AND their union is
written as ``test.csv`` for the unified loader (eval on a sub-split:
``--only_test=True --test_split=testA``).
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import pandas as pd


def convert(refer_dir: Path, out: Path, refs_file: str = "refs(berkeley).p") -> None:
    with open(refer_dir / refs_file, "rb") as f:
        refs = pickle.load(f)
    with open(refer_dir / "instances.json") as f:
        instances = json.load(f)

    ann_by_id = {a["id"]: a for a in instances["annotations"]}
    img_by_id = {i["id"]: i for i in instances["images"]}

    rows_by_split: dict[str, list[dict]] = {"train": [], "val": [], "test": []}
    for ref in refs:
        split = ref.get("split", "train")
        if split not in rows_by_split:
            if split.startswith("test"):  # testA/testB/… kept distinct
                rows_by_split[split] = []
            else:
                split = "train"
        ann = ann_by_id.get(ref["ann_id"])
        img = img_by_id.get(ref["image_id"])
        if ann is None or img is None:
            continue
        x, y, w, h = ann["bbox"]
        for sent in ref["sentences"]:
            rows_by_split[split].append(
                {
                    "img_id": img["file_name"],
                    "x1": x, "y1": y, "x2": x + w, "y2": y + h,
                    "query": sent["sent"].lower()
                    if "sent" in sent
                    else " ".join(sent["tokens"]),
                }
            )

    # Sub-test splits (testA/testB/…): own CSV each + union into test.csv,
    # preserving the toolkit's per-split eval protocol (VERDICT r2 #7).
    subtests = sorted(k for k in rows_by_split if k.startswith("test") and k != "test")
    for k in subtests:
        rows_by_split["test"].extend(rows_by_split[k])

    out_csv = out / "csv_dir"
    out_csv.mkdir(parents=True, exist_ok=True)
    for split, rows in rows_by_split.items():
        pd.DataFrame(rows).to_csv(out_csv / f"{split}.csv", index=False)
        print(f"{split}: {len(rows)} expressions")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--refer-dir", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--refs-file", default="refs(berkeley).p")
    a = ap.parse_args()
    convert(a.refer_dir, a.out, a.refs_file)


if __name__ == "__main__":
    main()
