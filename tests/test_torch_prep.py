"""The port's data-prep converters against the JAX package's, on the
release-format fixtures in ``tests/fixtures/`` (Flickr30k Entities, Visual
Genome) and on refer-toolkit pickles built here: each converter's CLI, run
with the same arguments in both packages, writes CSVs that read back as
equal DataFrames (exact: the converters are pure Python over pandas), and
the zero-shot splits of cases 0–3 built from them are equal too. The two
packages' ``tokenize`` agree on every fixture phrase."""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest

from zsgnet_tpu.data.prep import flickr30k as j_flickr
from zsgnet_tpu.data.prep import referit as j_referit
from zsgnet_tpu.data.prep import visual_genome as j_vg
from zsgnet_tpu.data.prep import zero_shot_splits as j_zs
from zsgnet_tpu.data.vocab import tokenize as j_tokenize
from zsgnet_tpu_torch.data.prep import flickr30k, referit, visual_genome, zero_shot_splits
from zsgnet_tpu_torch.data.vocab import tokenize

FIX = Path(__file__).parent / "fixtures"
ROOT = Path(__file__).resolve().parents[1]


def _run_cli(monkeypatch, module, args: list[str]) -> None:
    monkeypatch.setattr(sys, "argv", [module.__name__, *map(str, args)])
    module.main()


def _csvs(out: Path) -> dict[str, pd.DataFrame]:
    return {p.name: pd.read_csv(p) for p in sorted((out / "csv_dir").glob("*.csv"))}


def _assert_same_outputs(a: Path, b: Path) -> None:
    got, want = _csvs(a), _csvs(b)
    assert list(got) == list(want) and got
    for name in got:
        pd.testing.assert_frame_equal(got[name], want[name], check_exact=True)
    for extra in ("categories.json",):
        if (b / extra).exists():
            assert json.loads((a / extra).read_text()) == json.loads((b / extra).read_text())


def _fixture_phrases() -> list[str]:
    phrases = []
    for p in sorted((FIX / "flickr30k_entities" / "Sentences").glob("*.txt")):
        for line in p.read_text().splitlines():
            phrases.append(line)
            phrases += [t for _, t in flickr30k.parse_sentence(line)]
    for img in json.loads((FIX / "vg" / "region_descriptions.json").read_text()):
        phrases += [r["phrase"] for r in img["regions"]]
    return phrases + ["  Two  MEN,\tin [green] shirts .", "", "a_b-c 'd'"]


def test_tokenize_agrees_on_fixture_phrases():
    phrases = _fixture_phrases()
    assert len(phrases) > 20
    for s in phrases:
        assert tokenize(s) == j_tokenize(s), s


def test_flickr30k_cli_matches_jax(tmp_path, monkeypatch, capsys):
    root = FIX / "flickr30k_entities"
    args = ["--annotations", root / "Annotations", "--sentences", root / "Sentences",
            "--split-dir", root / "splits", "--out"]
    _run_cli(monkeypatch, flickr30k, [*args, tmp_path / "port"])
    port_log = capsys.readouterr().out
    _run_cli(monkeypatch, j_flickr, [*args, tmp_path / "jax"])
    assert port_log == capsys.readouterr().out
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert len(_csvs(tmp_path / "port")["train.csv"]) == 7


def _refer_dir(tmp_path: Path) -> Path:
    def ref(ref_id, ann_id, image_id, split, sents):
        return {
            "ref_id": ref_id, "ann_id": ann_id, "image_id": image_id, "category_id": 1,
            "split": split, "file_name": f"{image_id}.jpg", "sent_ids": list(range(len(sents))),
            "sentences": [{"sent_id": i, "raw": s, "sent": s.lower(), "tokens": s.lower().split()}
                          for i, s in enumerate(sents)],
        }

    refs = [
        ref(0, 10, 100, "train", ["A man on the left", "leftmost guy"]),
        ref(1, 11, 100, "val", ["the red car"]),
        ref(2, 12, 101, "testA", ["Woman in blue"]),
        ref(3, 13, 101, "testB", ["the middle chair"]),
    ]
    instances = {
        "images": [{"id": 100, "file_name": "19579_3.jpg", "width": 480, "height": 360},
                   {"id": 101, "file_name": "22footb_2.jpg", "width": 640, "height": 480}],
        "annotations": [
            {"id": 10, "image_id": 100, "bbox": [10, 20, 30, 40], "category_id": 1, "area": 1200},
            {"id": 11, "image_id": 100, "bbox": [50, 60, 70, 80], "category_id": 2, "area": 5600},
            {"id": 12, "image_id": 101, "bbox": [5, 6, 7, 8], "category_id": 1, "area": 56},
            {"id": 13, "image_id": 101, "bbox": [1, 2, 3, 4], "category_id": 3, "area": 12},
        ],
        "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "car"}, {"id": 3, "name": "chair"}],
    }
    d = tmp_path / "refclef"
    d.mkdir()
    with open(d / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    (d / "instances.json").write_text(json.dumps(instances))
    return d


def test_referit_cli_matches_jax(tmp_path, monkeypatch):
    args = ["--refer-dir", _refer_dir(tmp_path), "--refs-file", "refs(unc).p", "--out"]
    _run_cli(monkeypatch, referit, [*args, tmp_path / "port"])
    _run_cli(monkeypatch, j_referit, [*args, tmp_path / "jax"])
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert {"testA.csv", "testB.csv", "test.csv"} <= set(_csvs(tmp_path / "port"))


def test_visual_genome_cli_matches_jax(tmp_path, monkeypatch):
    args = ["--regions", FIX / "vg" / "region_descriptions.json", "--val-frac", "0.34",
            "--test-frac", "0.34", "--objects", FIX / "vg" / "objects.json", "--out"]
    _run_cli(monkeypatch, visual_genome, [*args, tmp_path / "port"])
    _run_cli(monkeypatch, j_vg, [*args, tmp_path / "jax"])
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    assert visual_genome.build_category_map(FIX / "vg" / "objects.json") == j_vg.build_category_map(
        FIX / "vg" / "objects.json")


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_zero_shot_splits_cli_matches_jax(tmp_path, monkeypatch, case):
    """Cases 0–1 on the Flickr30k fixture's CSVs, cases 2–3 on Visual
    Genome's, with the category map the VG converter wrote and a held-out
    category whose similar words make one image case 3 and one case 2."""
    if case < 2:
        root = FIX / "flickr30k_entities"
        flickr30k.convert(root / "Annotations", root / "Sentences", root / "splits", tmp_path / "src")
        cats = {"dog": "animal", "guys": "people", "men": "people", "shirts": "clothing"}
        hold = ["animal"]
        sim = {}
    else:
        visual_genome.convert(FIX / "vg" / "region_descriptions.json", tmp_path / "src", val_frac=0.34,
                              test_frac=0.34, objects_json=FIX / "vg" / "objects.json")
        csv = tmp_path / "src" / "csv_dir"
        rows = pd.concat([pd.read_csv(csv / s) for s in ("train.csv", "val.csv", "test.csv")],
                         ignore_index=True)
        rows.to_csv(csv / "test.csv", index=False)  # every region a test candidate
        cats = json.loads((tmp_path / "src" / "categories.json").read_text())
        hold = ["wolf"]
        sim = {"wolf": ["dog"]}
    for name, obj in (("cats.json", cats), ("hold.json", hold), ("sim.json", sim)):
        (tmp_path / name).write_text(json.dumps(obj))
    args = ["--csv-dir", tmp_path / "src" / "csv_dir", "--case", case, "--categories", tmp_path / "cats.json",
            "--holdout", tmp_path / "hold.json", "--similarity", tmp_path / "sim.json", "--out"]
    _run_cli(monkeypatch, zero_shot_splits, [*args, tmp_path / "port"])
    _run_cli(monkeypatch, j_zs, [*args, tmp_path / "jax"])
    _assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    test = _csvs(tmp_path / "port")["test.csv"]
    assert len(test) >= 1 and set(test["case"]) == {case}


def test_prep_modules_run_with_python_m(tmp_path):
    """``python -m zsgnet_tpu_torch.data.prep.<name>`` is the converter's
    CLI, and loads neither jax nor the JAX package."""
    root = FIX / "flickr30k_entities"
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['flickr30k', '--annotations', {str(root / 'Annotations')!r}, '--sentences', "
        f"{str(root / 'Sentences')!r}, '--split-dir', {str(root / 'splits')!r}, '--out', {str(tmp_path)!r}]\n"
        "runpy.run_module('zsgnet_tpu_torch.data.prep.flickr30k', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'zsgnet_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(pd.read_csv(tmp_path / "csv_dir" / "train.csv")) == 7
