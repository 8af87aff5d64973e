"""Qualitative visualization: draw grounding predictions onto images. Port
of ``zsgnet_tpu/viz.py``.

Box drawing is pure numpy and the PNG encode is PIL's:

* :func:`draw_box` — one rectangle outline onto an HWC uint8 array
  (clipped, any thickness);
* :func:`annotate_image` — the prediction (red), the ground truth (green)
  when given, and a score bar;
* :func:`gallery` — runs a ``Grounder`` over a split CSV and writes one
  panel per row, named by rank and IoU so the worst cases sort first.

CLI (one image, or a CSV gallery):
  python -m zsgnet_tpu_torch.viz <ckpt_dir> --image=img.jpg --query="red car" \\
      --out=pred.png [--gt=x1,y1,x2,y2] [--device=cuda]
  python -m zsgnet_tpu_torch.viz <ckpt_dir> --csv=data/.../val.csv \\
      --out_dir=tmp/gallery --n=32 [--device=cuda]
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["draw_box", "annotate_image", "gallery"]

PRED_COLOR = (230, 40, 40)    # red: prediction
GT_COLOR = (40, 200, 60)      # green: ground truth


def draw_box(img: np.ndarray, box_xyxy, color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """Draw a rectangle outline onto an (H, W, 3) uint8 image, in place.

    Coordinates are pixel xyxy; boxes are clipped to the frame (a box partly
    off the image draws its visible edges). Returns the same array.
    """
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected HWC uint8 image, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    x1, y1, x2, y2 = (int(round(float(v))) for v in box_xyxy)
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))
    c = np.asarray(color, np.uint8)
    t = max(int(thickness), 1)

    def _fill(ya, yb, xa, xb):
        ya, yb = max(ya, 0), min(yb, h)
        xa, xb = max(xa, 0), min(xb, w)
        if ya < yb and xa < xb:
            img[ya:yb, xa:xb] = c

    _fill(y1, y1 + t, x1, x2 + t)          # top
    _fill(y2, y2 + t, x1, x2 + t)          # bottom
    _fill(y1, y2 + t, x1, x1 + t)          # left
    _fill(y1, y2 + t, x2, x2 + t)          # right
    return img


def _score_bar(img: np.ndarray, score: float, color=PRED_COLOR) -> None:
    """A confidence readout without a font: a bar along the top edge whose
    filled fraction is the score (full width = 1.0)."""
    h, w = img.shape[:2]
    bar_h = max(h // 40, 2)
    img[:bar_h, :] = (30, 30, 30)
    img[:bar_h, : int(round(np.clip(score, 0.0, 1.0) * w))] = np.asarray(color, np.uint8)


def _iou_xyxy(a, b) -> float:
    ax1, ay1, ax2, ay2 = map(float, a)
    bx1, by1, bx2, by2 = map(float, b)
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = (max(0.0, ax2 - ax1) * max(0.0, ay2 - ay1)
             + max(0.0, bx2 - bx1) * max(0.0, by2 - by1) - inter)
    return inter / union if union > 0 else 0.0


def annotate_image(
    image: str | Path | np.ndarray,
    result: dict,
    gt_box_xyxy=None,
    out_path: str | Path | None = None,
    thickness: int = 2,
) -> np.ndarray:
    """One prediction panel: the red predicted box and score bar, the green
    ground truth when given. ``image`` is a path (loaded at its original
    size — ``result["box_xyxy"]`` is in original pixels) or an HWC uint8
    array already in the prediction's frame. Returns the annotated array
    and writes a PNG when ``out_path`` is given."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        panel = np.ascontiguousarray(image.astype(np.uint8)).copy()
    else:
        with Image.open(image) as im:
            panel = np.asarray(im.convert("RGB"), dtype=np.uint8).copy()
    if gt_box_xyxy is not None:
        draw_box(panel, gt_box_xyxy, GT_COLOR, thickness)
    draw_box(panel, result["box_xyxy"], PRED_COLOR, thickness)
    _score_bar(panel, float(result.get("score", 0.0)))
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(panel).save(out_path)
    return panel


def gallery(grounder, csv_path: str | Path, out_dir: str | Path, n: int = 32, thickness: int = 2) -> list[dict]:
    """Annotate the first ``n`` rows of a split CSV (the unified schema of
    ``data/dataset.py``) with the grounder's predictions against the ground
    truth, as ``<out_dir>/<rank>_iou<val>_row<i>.png`` in IoU order, the
    worst first. Returns the per-row records (row, query, IoU, score, boxes)."""
    import pandas as pd

    from zsgnet_tpu_torch.data.dataset import _parse_box

    csv_path, out_dir = Path(csv_path), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    df = pd.read_csv(csv_path).head(n)
    # Dataset layout: <root>/csv_dir/*.csv beside <root>/images/.
    img_root = csv_path.parent.parent / "images"
    paths = [p if (p := Path(str(f))).is_absolute() else img_root / p for f in df["img_id"]]
    queries = [str(q) for q in df["query"]]
    results = grounder.ground(paths, queries)
    records = []
    for i, res in enumerate(results):
        gt = _parse_box(df.iloc[i])
        records.append({
            "row": i,
            "img_id": str(df.iloc[i]["img_id"]),
            "query": queries[i],
            "iou": _iou_xyxy(res["box_xyxy"], gt),
            "score": res["score"],
            "pred_xyxy": res["box_xyxy"],
            "gt_xyxy": [float(v) for v in gt],
        })
    for rank, rec in enumerate(sorted(records, key=lambda r: r["iou"])):
        out = out_dir / f"{rank:03d}_iou{rec['iou']:.2f}_row{rec['row']}.png"
        annotate_image(paths[rec["row"]], {"box_xyxy": rec["pred_xyxy"], "score": rec["score"]},
                       gt_box_xyxy=rec["gt_xyxy"], out_path=out, thickness=thickness)
        rec["png"] = str(out)
    return records


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="Draw grounding predictions (red) against the ground "
                                             "truth (green) onto images: one query or a CSV gallery.")
    ap.add_argument("ckpt_dir", help="a Learner checkpoint directory (self-contained)")
    ap.add_argument("--image", help="one image's path")
    ap.add_argument("--query", help="the query phrase for --image")
    ap.add_argument("--out", default="prediction.png", help="output PNG (--image mode)")
    ap.add_argument("--gt", help="optional ground-truth box x1,y1,x2,y2 (--image mode)")
    ap.add_argument("--csv", help="a split CSV for gallery mode")
    ap.add_argument("--out_dir", default="tmp/gallery", help="gallery output directory")
    ap.add_argument("--n", type=int, default=32, help="gallery rows")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from zsgnet_tpu_torch.predict import Grounder

    g = Grounder.from_checkpoint(args.ckpt_dir, batch_size=args.batch_size, device=args.device)
    if args.csv:
        records = gallery(g, args.csv, args.out_dir, n=args.n)
        accurate = sum(r["iou"] > 0.5 for r in records)
        print(json.dumps({"panels": len(records), "acc@0.5": accurate / max(len(records), 1),
                          "out_dir": args.out_dir}))
        return
    if not (args.image and args.query):
        ap.error("either --csv or both --image and --query are required")
    res = g.ground([args.image], [args.query])[0]
    gt = [float(v) for v in args.gt.split(",")] if args.gt else None
    annotate_image(args.image, res, gt_box_xyxy=gt, out_path=args.out)
    print(json.dumps({"out": args.out, "score": res["score"], "box_xyxy": res["box_xyxy"]}))


if __name__ == "__main__":
    main()
