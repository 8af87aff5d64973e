"""Packed dataset cache — decode once, then read batches from a memmap.

Port of ``zsgnet_tpu/data/packed.py`` in the same on-disk format, so a
cache that either package built is read by the other. A one-time pass
writes every row's resized uint8 image into ``imgs.u8`` (an (N, H, W, 3)
memmap) and its tokenized query and boxes into ``meta.npz`` (``qvec``,
``qlens``, ``annot``, ``orig_annot``, ``img_size``, ``case``); epochs then
assemble batches by indexing the memmap, with no decode.

``key.json`` (``{"n", "h", "w", "csv_md5", "version": 2}``) ties the cache to
the resize resolution, the row count and the CSV's bytes, so an edited CSV
rebuilds it. A build writes temporary files and publishes them with
``os.replace``, the key last, so a crash leaves no valid key. An exclusive
``build.lock`` lets one process build while the others wait for the key;
a lock whose building process is gone is taken over.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np

from zsgnet_tpu_torch.data.dataset import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImgQuDataset,
    _load_image_u8,
    _parse_box,
    normalize_box_xyxy,
)

META_KEYS = ("qvec", "qlens", "annot", "orig_annot", "img_size", "case")
LOCK_WAIT_S = 3600.0  # how long a process waits on another's build before giving up


class PackedDataset:
    """``ImgQuDataset``'s items from the memmap cache: ``img`` uint8, or
    float32 normalized on read when ``cfg.normalize_on_device`` is off (the
    cache holds uint8 either way)."""

    def __init__(self, ds: ImgQuDataset, cache_dir: str | Path):
        self.cfg = ds.cfg
        self.cache_dir = Path(cache_dir)
        self._build_if_needed(ds)
        with np.load(self.cache_dir / "meta.npz") as meta:
            self.meta = {k: meta[k] for k in meta.files}
        h, w = self.cfg.resize_img
        self.imgs = np.memmap(self.cache_dir / "imgs.u8", dtype=np.uint8, mode="r",
                              shape=(len(self), h, w, 3))

    def _key(self, ds: ImgQuDataset) -> dict:
        h, w = self.cfg.resize_img
        csv_path = getattr(ds, "csv_path", None)
        csv_md5 = (hashlib.md5(Path(csv_path).read_bytes()).hexdigest()
                   if csv_path is not None and Path(csv_path).exists() else "")
        return {"n": len(ds), "h": h, "w": w, "csv_md5": csv_md5, "version": 2}

    def _key_matches(self, ds: ImgQuDataset) -> bool:
        try:
            return json.loads((self.cache_dir / "key.json").read_text()) == self._key(ds)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return False

    def _build_if_needed(self, ds: ImgQuDataset) -> None:
        if self._key_matches(ds):
            return
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        lock_path = self.cache_dir / "build.lock"
        try:
            os.close(os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            # Another process is building, or died mid-build: wait for the
            # key, and build here once the lock is gone without one.
            deadline = time.monotonic() + LOCK_WAIT_S
            while time.monotonic() < deadline:
                if self._key_matches(ds):
                    return
                if not lock_path.exists():
                    self._build_if_needed(ds)
                    return
                time.sleep(0.5)
            raise TimeoutError(f"packed-cache build lock stuck: {lock_path}")
        try:
            self._build(ds)
        finally:
            lock_path.unlink(missing_ok=True)

    def _build(self, ds: ImgQuDataset) -> None:
        h, w = self.cfg.resize_img
        n = len(ds)
        imgs = np.memmap(self.cache_dir / "imgs.u8.tmp", dtype=np.uint8, mode="w+", shape=(n, h, w, 3))
        meta: dict[str, list] = {k: [] for k in META_KEYS}
        for i in range(n):
            row = ds.df.iloc[i]
            img, orig_hw = _load_image_u8(ds.image_dir / str(row["img_id"]), self.cfg.resize_img)
            imgs[i] = img
            box_xyxy = _parse_box(row)
            ids, qlen = ds.vocab.encode(str(row["query"]), self.cfg.max_qlen)
            meta["qvec"].append(np.asarray(ids, np.int32))
            meta["qlens"].append(np.int32(qlen))
            meta["annot"].append(normalize_box_xyxy(box_xyxy, orig_hw))
            meta["orig_annot"].append(box_xyxy)
            meta["img_size"].append(np.asarray(orig_hw, np.float32))
            meta["case"].append(np.int32(row["case"]) if ds.has_case else np.int32(-1))
        imgs.flush()
        del imgs
        # A file object keeps np.savez from appending ".npz" to the name.
        with open(self.cache_dir / "meta.npz.tmp", "wb") as f:
            np.savez(f, **{k: np.stack(v) for k, v in meta.items()})
        # Data files first, the key last.
        os.replace(self.cache_dir / "imgs.u8.tmp", self.cache_dir / "imgs.u8")
        os.replace(self.cache_dir / "meta.npz.tmp", self.cache_dir / "meta.npz")
        (self.cache_dir / "key.json").write_text(json.dumps(self._key(ds)))

    def __len__(self) -> int:
        return len(self.meta["qlens"])

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        img = np.asarray(self.imgs[i])
        if not self.cfg.normalize_on_device:
            img = (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return {
            "img": img,
            **{k: self.meta[k][i] for k in ("qvec", "qlens", "annot", "orig_annot", "img_size")},
            "idxs": np.int32(i),
            "case": self.meta["case"][i],
        }
