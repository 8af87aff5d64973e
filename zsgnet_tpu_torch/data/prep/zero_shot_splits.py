"""Zero-shot split construction — the paper's cases 0–3 (SURVEY.md §2 #12).

Builds the evaluation regimes of "Zero-Shot Grounding of Objects from
Natural Language Queries" (arXiv:1908.07129) from unified CSVs:

  * **Case 0** (Flickr-Split-0, unseen words): test queries contain ≥1
    noun absent from every train query.
  * **Case 1** (Flickr-Split-1, unseen categories): the referred object's
    category never occurs in train; train rows of held-out categories are
    dropped.
  * **Case 2** (VG, novel category, no similar distractor): like case 1
    on VG, and images are filtered so no *other* object in the image
    shares the held-out category's semantic neighborhood.
  * **Case 3** (VG, novel category WITH similar distractors): the image
    contains ≥1 distractor object semantically similar to the target
    (A/B sub-variants by similarity threshold).

Category and similarity inputs are files: the word→category map for VG is
generated from the standard ``objects.json`` by ``visual_genome.py
--objects`` (WordNet-synset-head categories + per-image object lists —
the dataset's own annotations, no external resources), or hand-provided
for Flickr; the optional word-similarity table stays external (the
original derives from word2vec). Case 0 needs no resources.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import pandas as pd

from zsgnet_tpu_torch.data.vocab import tokenize


def split_case0(train: pd.DataFrame, test: pd.DataFrame) -> pd.DataFrame:
    """Unseen-words split: keep test rows whose query has a novel token."""
    train_words = set()
    for q in train["query"]:
        train_words.update(tokenize(str(q)))
    mask = [
        any(w not in train_words for w in tokenize(str(q))) for q in test["query"]
    ]
    out = test[mask].copy()
    out["case"] = 0
    return out


def split_case1(
    train: pd.DataFrame, test: pd.DataFrame, categories: dict[str, str],
    holdout: set[str],
) -> tuple[pd.DataFrame, pd.DataFrame]:
    """Unseen-categories: drop held-out categories from train; test keeps
    only held-out-category rows. ``categories``: head-noun → category."""

    def row_cat(q: str) -> str | None:
        for w in reversed(tokenize(q)):  # head noun is usually last
            if w in categories:
                return categories[w]
        return None

    train_keep = train[[row_cat(str(q)) not in holdout for q in train["query"]]].copy()
    test_keep = test[[row_cat(str(q)) in holdout for q in test["query"]]].copy()
    test_keep["case"] = 1
    return train_keep, test_keep


def split_cases23(
    test: pd.DataFrame, categories: dict[str, str], holdout: set[str],
    similarity: dict[str, list[str]] | None,
) -> pd.DataFrame:
    """VG cases 2/3: novel-category rows, case 3 iff a semantically-similar
    object co-occurs in the same image (needs per-image object lists in an
    ``objects`` column: JSON list of object names)."""

    def row_cat(q: str) -> str | None:
        for w in reversed(tokenize(q)):
            if w in categories:
                return categories[w]
        return None

    rows = []
    for _, r in test.iterrows():
        cat = row_cat(str(r["query"]))
        if cat not in holdout:
            continue
        case = 2
        if similarity is not None and "objects" in r and isinstance(r["objects"], str):
            sim_words = set(similarity.get(cat, []))
            objs = set(json.loads(r["objects"]))
            if objs & sim_words:
                case = 3
        rr = dict(r)
        rr["case"] = case
        rows.append(rr)
    return pd.DataFrame(rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv-dir", type=Path, required=True, help="unified csv_dir with train/test.csv")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--case", type=int, choices=(0, 1, 2, 3), required=True)
    ap.add_argument("--categories", type=Path, help="JSON word→category map (cases 1-3)")
    ap.add_argument("--holdout", type=Path, help="JSON list of held-out categories")
    ap.add_argument("--similarity", type=Path, help="JSON category→[similar words] (case 3)")
    a = ap.parse_args()

    train = pd.read_csv(a.csv_dir / "train.csv")
    test = pd.read_csv(a.csv_dir / "test.csv")
    out_csv = a.out / "csv_dir"
    out_csv.mkdir(parents=True, exist_ok=True)

    if a.case == 0:
        test_out = split_case0(train, test)
        train_out = train
    else:
        cats = json.loads(a.categories.read_text())
        hold = set(json.loads(a.holdout.read_text()))
        if a.case == 1:
            train_out, test_out = split_case1(train, test, cats, hold)
        else:
            sim = json.loads(a.similarity.read_text()) if a.similarity else None
            test_out = split_cases23(test, cats, hold, sim)
            test_out = test_out[test_out["case"] == a.case]
            train_out, _ = split_case1(train, test, cats, hold)

    train_out.to_csv(out_csv / "train.csv", index=False)
    val = pd.read_csv(a.csv_dir / "val.csv") if (a.csv_dir / "val.csv").exists() else test_out
    val.to_csv(out_csv / "val.csv", index=False)
    test_out.to_csv(out_csv / "test.csv", index=False)
    print(f"case {a.case}: train={len(train_out)} test={len(test_out)}")


if __name__ == "__main__":
    main()
