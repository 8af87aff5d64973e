"""The port's packed uint8 cache (``zsgnet_tpu_torch/data/packed.py``)
against the JAX package's (``zsgnet_tpu/data/packed.py``): the same files
from the same CSV (``imgs.u8`` and ``key.json`` byte-equal, ``meta.npz``
array-equal), a cache built by either package read by the other item for
item, a CSV edit rebuilding it, a held ``build.lock`` waited on, and
``get_data(use_packed_cache=True)`` batches equal to the CSV path's and to
the JAX package's."""

import shutil
import threading
import time

import numpy as np
import pandas as pd
import pytest

from zsgnet_tpu.config import Config as JConfig
from zsgnet_tpu.data.dataset import ImgQuDataset as JImgQuDataset
from zsgnet_tpu.data.dataset import get_data as j_get_data
from zsgnet_tpu.data.packed import PackedDataset as JPackedDataset
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data import packed, synthetic
from zsgnet_tpu_torch.data.dataset import GroupedDataset, ImgQuDataset, get_data
from zsgnet_tpu_torch.data.packed import PackedDataset
from zsgnet_tpu_torch.data.vocab import Vocab

SMALL = dict(resize_img=(48, 48), max_qlen=6, bs=4, nw=1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    synthetic.generate(root, n_train=12, n_val=6, n_test=4, img_size=64, all_objects=True)
    return root


def _pair(csv, img_dir, **kw):
    queries = pd.read_csv(csv)["query"].astype(str)
    args = {**SMALL, **kw}
    return (ImgQuDataset(csv, img_dir, Vocab.build(queries), Config(**args)),
            JImgQuDataset(csv, img_dir, JVocab.build(queries), JConfig(**args)))


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert set(x) == set(y)
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"item {i} key {k}")


def test_cache_files_equal_jax(synth, tmp_path):
    csv, imgs = synth / "synthetic" / "csv_dir" / "train.csv", synth / "synthetic" / "images"
    t_ds, j_ds = _pair(csv, imgs)
    t = PackedDataset(t_ds, tmp_path / "port")
    JPackedDataset(j_ds, tmp_path / "jax")
    for name in ("imgs.u8", "key.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    with np.load(tmp_path / "port" / "meta.npz") as pm, np.load(tmp_path / "jax" / "meta.npz") as jm:
        assert sorted(pm.files) == sorted(jm.files) == sorted(
            ["qvec", "qlens", "annot", "orig_annot", "img_size", "case"])
        for k in jm.files:
            assert pm[k].dtype == jm[k].dtype
            np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["imgs.u8", "key.json", "meta.npz"]
    # The packed items are the CSV items (uint8, decoded once).
    _assert_items_equal(t, t_ds)


@pytest.mark.parametrize("normalize_on_device", [True, False])
def test_cache_read_across_packages(synth, tmp_path, normalize_on_device):
    """A cache JAX built is read by the port without a rebuild, and the
    reverse, item for item; float items are normalized on read alike."""
    csv, imgs = synth / "synthetic" / "csv_dir" / "val.csv", synth / "synthetic" / "images"
    t_ds, j_ds = _pair(csv, imgs, normalize_on_device=normalize_on_device)
    j_built = JPackedDataset(j_ds, tmp_path / "a")
    t_built = PackedDataset(t_ds, tmp_path / "b")
    stamps = {p: p.stat().st_mtime_ns for d in ("a", "b") for p in (tmp_path / d).iterdir()}
    _assert_items_equal(PackedDataset(t_ds, tmp_path / "a"), j_built)
    _assert_items_equal(JPackedDataset(j_ds, tmp_path / "b"), t_built)
    assert {p: p.stat().st_mtime_ns for p in stamps} == stamps  # nothing rebuilt
    assert t_built[0]["img"].dtype == (np.uint8 if normalize_on_device else np.float32)


def test_csv_edit_invalidates(synth, tmp_path):
    root = tmp_path / "data"
    shutil.copytree(synth, root)
    csv, imgs = root / "synthetic" / "csv_dir" / "train.csv", root / "synthetic" / "images"
    t_ds, _ = _pair(csv, imgs)
    q0 = PackedDataset(t_ds, tmp_path / "cache")[0]["qvec"].copy()
    df = pd.read_csv(csv)
    df.loc[0, "query"] = "zzz unseen words here"  # same row count, new content
    df.to_csv(csv, index=False)
    t_ds2 = ImgQuDataset(csv, imgs, t_ds.vocab, t_ds.cfg)
    q1 = PackedDataset(t_ds2, tmp_path / "cache")[0]["qvec"]
    assert not np.array_equal(q0, q1), "stale packed cache served after a CSV edit"
    np.testing.assert_array_equal(q1, t_ds2[0]["qvec"])


def test_held_lock_is_waited_on_then_rebuilt(synth, tmp_path, monkeypatch):
    """A lock another process holds is waited on; once it goes without a key
    (the process building died), this one builds. A lock held past the wait
    raises."""
    csv, imgs = synth / "synthetic" / "csv_dir" / "test.csv", synth / "synthetic" / "images"
    t_ds, _ = _pair(csv, imgs)
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "build.lock").touch()
    monkeypatch.setattr(packed, "LOCK_WAIT_S", 0.6)
    with pytest.raises(TimeoutError, match="build lock stuck"):
        PackedDataset(t_ds, cache)
    monkeypatch.setattr(packed, "LOCK_WAIT_S", 60.0)
    release = threading.Timer(1.0, (cache / "build.lock").unlink)
    release.start()
    t0 = time.monotonic()
    ds = PackedDataset(t_ds, cache)
    assert time.monotonic() - t0 >= 0.9 and not (cache / "build.lock").exists()
    _assert_items_equal(ds, t_ds)


@pytest.mark.parametrize("queries_per_img", [1, 2])
def test_get_data_packed_batches_equal_csv_and_jax(synth, tmp_path, queries_per_img):
    """Train (shuffled) and validation batches through the cache equal the
    CSV path's and the JAX package's packed batches; grouped units wrap the
    cache as in JAX."""
    kw = dict(SMALL, ds_to_use="synthetic", data_dir=str(synth), tmp_path=str(tmp_path),
              queries_per_img=queries_per_img, bs=2 if queries_per_img > 1 else 4)
    csv = get_data(Config(**kw))
    packed = get_data(Config(**kw, use_packed_cache=True))
    jax = j_get_data(JConfig(**kw, use_packed_cache=True))
    inner = packed.train_dl.ds.ds if queries_per_img > 1 else packed.train_dl.ds
    assert isinstance(inner, PackedDataset)
    assert isinstance(packed.train_dl.ds, GroupedDataset) == (queries_per_img > 1)
    assert (synth / "synthetic" / "csv_dir" / "packed_train_48x48" / "key.json").exists()
    for name in ("train_dl", "valid_dl"):
        for c, p, j in zip(getattr(csv, name), getattr(packed, name), getattr(jax, name)):
            assert set(p) == set(c) == set(j)
            for k in c:
                np.testing.assert_array_equal(p[k], c[k], err_msg=f"{name} {k} (csv)")
                np.testing.assert_array_equal(p[k], j[k], err_msg=f"{name} {k} (jax)")
