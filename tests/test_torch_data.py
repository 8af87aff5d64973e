"""The port's copies of the host-side data modules against the JAX
package's: the synthetic generator writes the same files, the vocab gives
the same ids, and the CSV dataset and the evaluation loader give the same
samples, tail padding and ``valid`` mask."""

import numpy as np
import pandas as pd
import pytest

from zsgnet_tpu.config import Config as JConfig
from zsgnet_tpu.data import dataset as j_dataset
from zsgnet_tpu.data.synthetic import generate as j_generate
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu_torch.config import Config as TConfig
from zsgnet_tpu_torch.data import dataset as t_dataset
from zsgnet_tpu_torch.data.synthetic import generate as t_generate
from zsgnet_tpu_torch.data.vocab import Vocab as TVocab


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    kw = dict(n_train=6, n_val=5, n_test=2, img_size=48, seed=3)
    return (
        j_generate(tmp_path_factory.mktemp("jax"), **kw),
        t_generate(tmp_path_factory.mktemp("port"), **kw),
    )


def test_synthetic_generator_writes_the_same_files(roots):
    j_root, t_root = roots
    for split in ("train", "val", "test"):
        pd.testing.assert_frame_equal(
            pd.read_csv(t_root / "csv_dir" / f"{split}.csv"),
            pd.read_csv(j_root / "csv_dir" / f"{split}.csv"),
        )
    j_imgs = sorted(p.name for p in (j_root / "images").iterdir())
    assert j_imgs == sorted(p.name for p in (t_root / "images").iterdir())
    for name in j_imgs:
        assert (t_root / "images" / name).read_bytes() == (j_root / "images" / name).read_bytes()


def test_vocab_matches_jax(roots, tmp_path):
    queries = pd.read_csv(roots[1] / "csv_dir" / "train.csv")["query"].tolist()
    queries += ["A  Mixed-case query", ""]
    tv, jv = TVocab.build(queries), JVocab.build(queries)
    assert tv.word_to_id == jv.word_to_id
    for q in ("the red box", "unseen words here", "", "the " * 20):
        assert tv.encode(q, 8) == jv.encode(q, 8)
    tv.save(tmp_path / "vocab.json")
    assert JVocab.load(tmp_path / "vocab.json").word_to_id == jv.word_to_id


@pytest.mark.parametrize("decode", ["native", "pil"])
def test_dataset_and_eval_loader_match_jax(roots, monkeypatch, decode):
    """Against the JAX loader with both packages decoding natively (their
    default), and with both on their PIL fallback (no native library)."""
    from zsgnet_tpu.data import native as j_native
    from zsgnet_tpu_torch.data import native as t_native

    if decode == "pil":
        monkeypatch.setattr(j_native, "_load", lambda: None)
        monkeypatch.setattr(t_native, "_load", lambda: None)
    root = roots[1]
    kw = dict(resize_img=(40, 56), max_qlen=6)
    queries = pd.read_csv(root / "csv_dir" / "train.csv")["query"].tolist()
    csv, imgs = root / "csv_dir" / "val.csv", root / "images"
    t_ds = t_dataset.ImgQuDataset(csv, imgs, TVocab.build(queries), TConfig(**kw))
    j_ds = j_dataset.ImgQuDataset(csv, imgs, JVocab.build(queries), JConfig(**kw))
    t_batches = list(t_dataset.BatchLoader(t_ds, 4, shuffle=False, nw=1, drop_last=False))
    j_batches = list(j_dataset.BatchLoader(j_ds, 4, shuffle=False, nw=1, drop_last=False))
    assert len(t_batches) == len(j_batches) == 2
    for tb, jb in zip(t_batches, j_batches):
        assert set(tb) == set(jb)
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert t_batches[-1]["valid"].tolist() == [True, False, False, False]
    assert t_batches[0]["img"].dtype == np.uint8


def test_normalize_box_matches_jax():
    box = np.array([10.0, 20.0, 110.0, 70.0], np.float32)
    np.testing.assert_array_equal(
        t_dataset.normalize_box_xyxy(box, (80, 200)), j_dataset.normalize_box_xyxy(box, (80, 200))
    )
    np.testing.assert_array_equal(t_dataset.IMAGENET_MEAN, j_dataset.IMAGENET_MEAN)
    np.testing.assert_array_equal(t_dataset.IMAGENET_STD, j_dataset.IMAGENET_STD)
