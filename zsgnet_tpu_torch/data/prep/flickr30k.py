"""Flickr30k Entities → unified CSV.

Parses the standard Flickr30k Entities release layout:
  * ``Annotations/<img_id>.xml`` — PASCAL-VOC-style boxes tagged with
    coreference-chain ids; objects may instead carry ``<nobndbox>1``
    (annotated as unboxable) or ``<scene>1`` (whole-image scene region);
  * ``Sentences/<img_id>.txt`` — one sentence per line with phrase markup
    ``[/EN#<chain_id>/<type>[/<type2>…] the phrase words]``; type is one
    of people/clothing/bodyparts/animals/vehicles/instruments/scene/
    other/notvisual, and a phrase can carry several.

Phrase filtering mirrors the reference pipeline's grounding granularity:
``notvisual`` phrases (chain 0 — "[/EN#0/notvisual no words]") are never
grounding targets and are dropped; ``scene`` phrases are dropped unless
their chain has a real box (scene chains are usually ``<scene>1`` in the
XML — whole-image, unboxable); every other (phrase, box) pair becomes one
CSV row. Phrases whose chain has multiple boxes use the union box (the
dataset's convention for plural entities).

Splits follow the standard train/val/test image lists (pass ``--split-dir``
containing train.txt/val.txt/test.txt of image ids).
"""

from __future__ import annotations

import argparse
import re
import xml.etree.ElementTree as ET
from pathlib import Path

import pandas as pd

# [/EN#283585/people A woman] — chain id, one-or-more /type tags, words.
_PHRASE_RE = re.compile(r"\[/EN#(\d+)((?:/[A-Za-z]+)*)\s([^\]]+)\]")


def parse_sentence(line: str) -> list[tuple[int, str]]:
    """→ [(chain_id, phrase), ...] from one marked-up sentence."""
    return [(c, p) for c, _t, p in parse_sentence_typed(line)]


def parse_sentence_typed(line: str) -> list[tuple[int, tuple[str, ...], str]]:
    """→ [(chain_id, (type, ...), phrase), ...] — multi-type phrases like
    ``/EN#123/people/scene`` keep every tag."""
    out = []
    for m in _PHRASE_RE.finditer(line):
        types = tuple(t for t in m.group(2).split("/") if t)
        out.append((int(m.group(1)), types, m.group(3).strip()))
    return out


def parse_annotation_xml(path: Path) -> dict[int, list[tuple[float, float, float, float]]]:
    """→ chain_id → [(x1, y1, x2, y2), ...].

    Objects carrying ``<nobndbox>1`` or ``<scene>1`` instead of a
    ``<bndbox>`` contribute no box — their chains simply stay absent, and
    ``convert`` drops the corresponding phrases.
    """
    root = ET.parse(path).getroot()
    boxes: dict[int, list[tuple[float, float, float, float]]] = {}
    for obj in root.findall("object"):
        names = [n.text for n in obj.findall("name")]
        bb = obj.find("bndbox")
        if bb is None:
            continue
        coords = tuple(
            float(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")
        )
        for name in names:
            try:
                chain = int(name)
            except (TypeError, ValueError):
                continue
            boxes.setdefault(chain, []).append(coords)
    return boxes


def union_box(boxes: list[tuple[float, float, float, float]]) -> tuple[float, float, float, float]:
    xs1, ys1, xs2, ys2 = zip(*boxes)
    return min(xs1), min(ys1), max(xs2), max(ys2)


def convert(
    annotations: Path, sentences: Path, split_dir: Path, out: Path, img_ext: str = ".jpg"
) -> None:
    out_csv = out / "csv_dir"
    out_csv.mkdir(parents=True, exist_ok=True)
    dropped = {"notvisual": 0, "scene": 0, "noboxes": 0}
    for split in ("train", "val", "test"):
        ids = (split_dir / f"{split}.txt").read_text().split()
        rows = []
        for img_id in ids:
            ann_path = annotations / f"{img_id}.xml"
            sent_path = sentences / f"{img_id}.txt"
            if not ann_path.exists() or not sent_path.exists():
                continue
            chain_boxes = parse_annotation_xml(ann_path)
            for line in sent_path.read_text().splitlines():
                for chain, types, phrase in parse_sentence_typed(line):
                    if not phrase:
                        continue
                    if chain == 0 or "notvisual" in types:
                        dropped["notvisual"] += 1
                        continue
                    if chain not in chain_boxes:
                        # scene chains are whole-image (<scene>1, no box);
                        # others may be <nobndbox>1 or unannotated.
                        dropped["scene" if "scene" in types else "noboxes"] += 1
                        continue
                    x1, y1, x2, y2 = union_box(chain_boxes[chain])
                    rows.append(
                        {
                            "img_id": f"{img_id}{img_ext}",
                            "x1": x1, "y1": y1, "x2": x2, "y2": y2,
                            "query": phrase.lower(),
                        }
                    )
        pd.DataFrame(rows).to_csv(out_csv / f"{split}.csv", index=False)
        print(f"{split}: {len(rows)} phrase-box pairs")
    print(
        f"dropped: {dropped['notvisual']} notvisual, {dropped['scene']} scene "
        f"(boxless), {dropped['noboxes']} other boxless chains"
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--annotations", type=Path, required=True)
    ap.add_argument("--sentences", type=Path, required=True)
    ap.add_argument("--split-dir", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args()
    convert(a.annotations, a.sentences, a.split_dir, a.out)


if __name__ == "__main__":
    main()
