"""CSV grounding dataset, batch loader and ``get_data`` — port of
``zsgnet_tpu/data/dataset.py``.

The unified CSV schema (``img_id``, pixel ``x1 y1 x2 y2`` or a JSON
``bbox`` column, ``query``, optional ``case``), Pillow-bilinear resize to
``cfg.resize_img``, queries padded to ``cfg.max_qlen``, and boxes as
normalized [-1, 1] tlbr (y1, x1, y2, x2).

Images decode as the JAX package decodes them: PNG and JPEG through the
native pipeline (``data/native.py``) first, PIL for what it cannot take,
so both packages see the same pixels. With ``cfg.normalize_on_device``
(the default) items carry uint8 HWC images that the model normalizes on
the device; with it off they carry float32 images normalized on the host.

``BatchLoader`` visits the JAX loader's batches in the JAX loader's order:
epoch ``e`` shuffles with ``default_rng((seed, e))``; ``drop_last=False``
pads the tail by wrapping and marks the real rows in ``valid``. ``get_data``
builds the train (shuffled, drop-last), validation and test loaders and
caches the vocab beside the CSVs. ``cfg.use_packed_cache`` reads each split
through the packed uint8 cache (``data/packed.py``, the JAX package's
on-disk format). With ``cfg.queries_per_img`` Q > 1 the loaders serve
``GroupedDataset`` units of one image and Q phrases, the JAX package's
units exactly.

Under data parallelism (``shard_id``, ``num_shards``) every rank walks the
same global batch sequence and collates only its slice of each global
batch, as the JAX loader does for its hosts. Under spatial partitioning
the shards are the data indices (``parallel.mesh.data_shard``): the
members of a spatial group collate the same slice, and the step cuts each
member's rows of the images.
"""

from __future__ import annotations

import io
import json
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import pandas as pd

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data import native
from zsgnet_tpu_torch.data.vocab import Vocab

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _load_image(path: Path, resize_hw: tuple[int, int]) -> tuple[np.ndarray, tuple[int, int]]:
    """→ (HWC float32 image normalized on the host, original (H, W)).

    PNG and JPEG decode, resize and normalize in one native call; other
    formats, and files the library refuses, decode with PIL and resize and
    normalize natively; without the library, PIL does it all."""
    path = Path(path)
    if path.suffix.lower() in (".png", ".jpg", ".jpeg"):
        out = native.image_load(path.read_bytes(), resize_hw, IMAGENET_MEAN, IMAGENET_STD)
        if out is not None:
            return out
    from PIL import Image

    native.record("pil")
    with Image.open(path) as im:
        im = im.convert("RGB")
        orig_w, orig_h = im.size
        arr_u8 = np.asarray(im, dtype=np.uint8)
    out2 = native.resize_normalize_rgb(arr_u8, resize_hw, IMAGENET_MEAN, IMAGENET_STD)
    if out2 is not None:
        return out2, (orig_h, orig_w)
    with Image.open(path) as im:  # pure-PIL fallback
        im = im.convert("RGB").resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD, (orig_h, orig_w)


def load_image_bytes_u8(
    data: bytes, resize_hw: tuple[int, int]
) -> tuple[np.ndarray, tuple[int, int]]:
    """Encoded bytes → (HWC uint8 resized image, original (H, W)): native
    PNG/JPEG decode first, then PIL decode with the native resize, then PIL
    alone. Also the serving daemon's decode of request-body images."""
    out = native.image_load_u8(data, resize_hw)
    if out is not None:
        return out
    from PIL import Image

    native.record("pil")
    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB")
        orig_w, orig_h = im.size
        arr_u8 = np.asarray(im, dtype=np.uint8)
    out2 = native.resize_u8(arr_u8, resize_hw)
    if out2 is not None:
        return out2, (orig_h, orig_w)
    with Image.open(io.BytesIO(data)) as im:  # pure-PIL fallback
        im = im.convert("RGB").resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8), (orig_h, orig_w)


def _load_image_u8(path: Path, resize_hw: tuple[int, int]) -> tuple[np.ndarray, tuple[int, int]]:
    """Path wrapper over ``load_image_bytes_u8``."""
    return load_image_bytes_u8(Path(path).read_bytes(), resize_hw)


def _parse_box(row: pd.Series) -> np.ndarray:
    """Pixel (x1, y1, x2, y2) from either 4 columns or a JSON 'bbox' column."""
    if "bbox" in row and isinstance(row["bbox"], str):
        vals = json.loads(row["bbox"])
    elif "bbox" in row and isinstance(row["bbox"], (list, tuple)):
        vals = row["bbox"]
    else:
        vals = [row["x1"], row["y1"], row["x2"], row["y2"]]
    return np.asarray(vals, dtype=np.float32)


def normalize_box_xyxy(box_xyxy: np.ndarray, orig_hw: tuple[int, int]) -> np.ndarray:
    """Pixel xyxy (original frame) → normalized [-1,1] tlbr (y1,x1,y2,x2)."""
    h, w = float(orig_hw[0]), float(orig_hw[1])
    x1, y1, x2, y2 = box_xyxy
    return np.asarray(
        [y1 / h * 2 - 1, x1 / w * 2 - 1, y2 / h * 2 - 1, x2 / w * 2 - 1],
        dtype=np.float32,
    )


class ImgQuDataset:
    """One split of a grounding dataset backed by a CSV file.

    ``__getitem__`` returns the reference's batch keys: ``img`` (H, W, 3
    uint8, or float32 normalized on the host when ``cfg.normalize_on_device``
    is off), ``qvec`` (max_qlen int32), ``qlens`` (int32), ``annot`` (4,
    normalized tlbr), ``orig_annot`` (4, pixel xyxy), ``img_size`` (2,
    original H W), ``idxs`` (int32), ``case`` (int32, -1 if none).
    """

    def __init__(self, csv_path: str | Path, image_dir: str | Path, vocab: Vocab, cfg: Config):
        self.csv_path = Path(csv_path)
        self.df = pd.read_csv(csv_path)
        if "query" not in self.df.columns:
            raise ValueError(f"{csv_path}: CSV must have a 'query' column")
        self.image_dir = Path(image_dir)
        self.vocab = vocab
        self.cfg = cfg
        self.has_case = "case" in self.df.columns

    def __len__(self) -> int:
        return len(self.df)

    def queries(self) -> list[str]:
        return [str(q) for q in self.df["query"]]

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        loader = _load_image_u8 if self.cfg.normalize_on_device else _load_image
        img, orig_hw = loader(self.image_dir / str(self.df.iloc[i]["img_id"]), self.cfg.resize_img)
        return {"img": img, **self.meta_item(i, orig_hw)}

    def meta_item(self, i: int, orig_hw: tuple[int, int]) -> dict[str, np.ndarray]:
        """Every key but ``img``, given the image's original size (the
        grouped loader decodes an image once for all its rows)."""
        row = self.df.iloc[i]
        box_xyxy = _parse_box(row)
        ids, qlen = self.vocab.encode(str(row["query"]), self.cfg.max_qlen)
        return {
            "qvec": np.asarray(ids, dtype=np.int32),
            "qlens": np.int32(qlen),
            "annot": normalize_box_xyxy(box_xyxy, orig_hw),
            "orig_annot": box_xyxy,
            "img_size": np.asarray(orig_hw, dtype=np.float32),
            "idxs": np.int32(i),
            "case": np.int32(row["case"]) if self.has_case else np.int32(-1),
        }


class GroupedDataset:
    """Units of one image and Q phrases, for grouped multi-query batches
    (``cfg.queries_per_img``), built by grouping the rows on ``img_id``.

    An image with n phrases gives ceil(n/Q) units; a short unit is filled
    by wrapping over the image's own phrases, and ``pair_valid`` (Q,) marks
    the positions before the wrap. Over an ``ImgQuDataset`` or a
    ``PackedDataset``. Items: ``img`` (H, W, 3), read once through the first
    row, ``qvec`` (Q, T), ``qlens``/``idxs``/``case``
    (Q,), ``annot``/``orig_annot`` (Q, 4), ``img_size`` (2,), ``pair_valid``.
    With ``reseed`` each epoch permutes every image's phrases first, from
    ``default_rng((cfg.seed, epoch))`` (``BatchLoader.set_epoch``); the unit
    count does not depend on the permutation, so an epoch's length and a
    mid-epoch resume's batch index hold."""

    def __init__(self, ds, img_ids, queries_per_img: int, reseed: bool = False):
        self.ds = ds
        self.cfg = ds.cfg
        self.q = int(queries_per_img)
        self._reseed = bool(reseed)
        self._epoch: int | None = None
        groups: dict[str, list[int]] = {}
        for i, gid in enumerate(img_ids):
            groups.setdefault(str(gid), []).append(i)
        self._gids = sorted(groups)
        self._groups = groups
        self._build_units(None)

    def _build_units(self, rng: np.random.Generator | None) -> None:
        self.units: list[list[int]] = []
        self.n_real: list[int] = []  # positions before the wrap, per unit
        for gid in self._gids:
            idxs = self._groups[gid]
            if rng is not None:
                idxs = [idxs[k] for k in rng.permutation(len(idxs))]
            for s in range(0, len(idxs), self.q):
                chunk = idxs[s : s + self.q]
                self.n_real.append(len(chunk))
                chunk += [idxs[j % len(idxs)] for j in range(self.q - len(chunk))]
                self.units.append(chunk)

    def reseed(self, epoch: int) -> None:
        """The units of ``epoch`` (a no-op without ``reseed`` or for the
        epoch already built)."""
        if not self._reseed or epoch == self._epoch:
            return
        self._epoch = epoch
        self._build_units(np.random.default_rng((int(self.cfg.seed), int(epoch))))

    def __len__(self) -> int:
        return len(self.units)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        unit = self.units[i]
        first = self.ds[unit[0]]
        if hasattr(self.ds, "meta_item"):
            hw = (float(first["img_size"][0]), float(first["img_size"][1]))
            rows = [first] + [self.ds.meta_item(j, hw) for j in unit[1:]]
        else:  # PackedDataset: a row is a memmap read, no decode
            rows = [first] + [self.ds[j] for j in unit[1:]]
        out = {k: np.stack([r[k] for r in rows])
               for k in ("qvec", "qlens", "annot", "orig_annot", "idxs", "case")}
        out.update(img=first["img"], img_size=first["img_size"],
                   pair_valid=np.arange(self.q) < self.n_real[i])
        return out


def collate(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack a list of sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchLoader:
    """Deterministic prefetching batch iterator over ``ds``.

    * epoch ``e`` (``set_epoch``) has the permutation
      ``default_rng((seed, e)).permutation(n)`` when ``shuffle``;
    * ``drop_last=False`` pads the tail batch by wrapping; ``valid`` marks
      the real rows (all ones otherwise);
    * ``start_batch`` makes the next iteration start at that batch, once
      (mid-epoch resume, no decode work for the skipped batches);
    * ``nw`` decode threads keep at most ``nw + prefetch_depth`` batches in
      flight;
    * ``batch_size`` is the global batch: with ``num_shards`` > 1 every
      shard draws the same permutation and collates rows
      ``[shard_id·bs/n, (shard_id+1)·bs/n)`` of each global batch, with
      that slice of ``valid``.
    """

    def __init__(
        self, ds, batch_size: int, shuffle: bool, seed: int = 0,
        nw: int = 4, drop_last: bool = True, prefetch_depth: int = 2,
        shard_id: int = 0, num_shards: int = 1,
    ):
        self.ds = ds
        self.bs = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.nw = max(1, nw)
        self.drop_last = drop_last
        self.prefetch_depth = prefetch_depth
        self.shard_id = int(shard_id)
        self.num_shards = int(num_shards)
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int) -> None:
        """Shuffle for ``epoch``; a grouped dataset rebuilds its units."""
        self.epoch = epoch
        if isinstance(self.ds, GroupedDataset):
            self.ds.reseed(epoch)

    def _batch_indices(self) -> list[np.ndarray]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        if self.drop_last:
            return [order[i * self.bs : (i + 1) * self.bs] for i in range(n // self.bs)]
        batches = []
        for i in range(0, n, self.bs):
            chunk = order[i : i + self.bs]
            if len(chunk) < self.bs:  # wrap-pad; valid marks the tail
                chunk = np.concatenate([chunk, order[: self.bs - len(chunk)]])
            batches.append(chunk)
        return batches

    @property
    def local_bs(self) -> int:
        """This shard's rows of each global batch."""
        if self.bs % self.num_shards:
            raise ValueError(f"global batch size {self.bs} not divisible by {self.num_shards} hosts")
        return self.bs // self.num_shards

    def __len__(self) -> int:
        return len(self._batch_indices())

    def _assemble(self, bi: int, batches: list[np.ndarray]) -> dict[str, np.ndarray]:
        lo = self.shard_id * self.local_bs
        hi = lo + self.local_bs
        batch = collate([self.ds[int(i)] for i in batches[bi][lo:hi]])
        real = len(self.ds) - (len(batches) - 1) * self.bs
        if not self.drop_last and bi == len(batches) - 1:
            batch["valid"] = (np.arange(self.bs) < real)[lo:hi]
        else:
            batch["valid"] = np.ones(hi - lo, dtype=bool)
        return batch

    def first_batch(self) -> dict[str, np.ndarray]:
        """Batch 0 of the current epoch, decoded inline (no threads)."""
        return self._assemble(0, self._batch_indices())

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        batches = self._batch_indices()
        start = min(self.start_batch, len(batches))
        self.start_batch = 0
        out: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer has gone."""
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            window = self.nw + self.prefetch_depth
            try:
                with ThreadPoolExecutor(self.nw) as pool:
                    pending: deque = deque()
                    for bi in range(start, len(batches)):
                        pending.append(pool.submit(self._assemble, bi, batches))
                        if len(pending) >= window and not put(pending.popleft().result()):
                            return
                    while pending:
                        if not put(pending.popleft().result()):
                            return
                put(None)
            except Exception as e:  # a decode error reaches the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


@dataclass
class DataWrap:
    """The loaders and the vocab of one dataset (reference ``DataWrap``)."""

    path: Path
    train_dl: BatchLoader
    valid_dl: BatchLoader
    test_dl: BatchLoader | None
    vocab: Vocab


# Dataset name → (CSV dir, image dir) under cfg.data_dir.
DATASET_LAYOUT = {
    "refclef": ("refclef/csv_dir", "refclef/images"),
    "flickr30k": ("flickr30k/csv_dir", "flickr30k/images"),
    "flickr_split0": ("flickr30k_c0/csv_dir", "flickr30k/images"),
    "flickr_split1": ("flickr30k_c1/csv_dir", "flickr30k/images"),
    "vg_split_c2": ("vg_split_c2/csv_dir", "visual_genome/images"),
    "vg_split_c3": ("vg_split_c3/csv_dir", "visual_genome/images"),
    "synthetic": ("synthetic/csv_dir", "synthetic/images"),
}


def get_data(cfg: Config, shard_id: int = 0, num_shards: int = 1) -> DataWrap:
    """Train/val/test loaders and the vocab (reference ``get_data(cfg)``);
    each loader collates shard ``shard_id`` of ``num_shards`` of every
    global batch of ``cfg.bs`` (:class:`BatchLoader`).

    Expects ``<data_dir>/<CSV dir>/{train,val,<test_split>}.csv`` and the
    image dir of :data:`DATASET_LAYOUT`. The vocab is built from the train
    queries (``vocab_splits="train"``) or from every split present
    (``"all"``) and cached beside the CSVs under the JAX package's names,
    so either package reuses the other's cache.

    ``cfg.use_packed_cache`` reads every split through its packed cache,
    ``packed_<split>_<h>x<w>`` beside the CSVs, built on first use.
    With ``cfg.queries_per_img > 1`` every split is grouped by ``img_id``
    (train reseeded per epoch under ``cfg.grouped_reseed``); the train split
    needs the column, an evaluation split without it stays flat.
    """
    if cfg.ds_to_use not in DATASET_LAYOUT:
        raise ValueError(f"unknown ds_to_use={cfg.ds_to_use!r}; known: {sorted(DATASET_LAYOUT)}")
    csv_sub, img_sub = DATASET_LAYOUT[cfg.ds_to_use]
    root = Path(cfg.data_dir)
    csv_dir, img_dir = root / csv_sub, root / img_sub
    if cfg.vocab_splits == "train":
        stems = ["train"]
    else:
        stems = list(dict.fromkeys(["train", "val", "test", cfg.test_split]))
    # Checked before any cache write: a partial data dir must not leave a
    # near-empty vocab behind for later runs.
    if not (csv_dir / "train.csv").exists():
        raise FileNotFoundError(f"missing train.csv under {csv_dir}")
    present = [s for s in stems if (csv_dir / f"{s}.csv").exists()]
    vocab_path = csv_dir / (
        "vocab.json" if cfg.vocab_splits == "train" else "vocab_all_" + "-".join(present) + ".json"
    )
    if vocab_path.exists():
        vocab = Vocab.load(vocab_path)
    else:
        queries: list[str] = []
        for stem in present:
            queries.extend(str(q) for q in pd.read_csv(csv_dir / f"{stem}.csv")["query"])
        vocab = Vocab.build(queries)
        vocab.save(vocab_path)

    def loader(split: str, shuffle: bool, drop_last: bool) -> BatchLoader | None:
        csv_path = csv_dir / f"{split}.csv"
        if not csv_path.exists():
            return None
        ds = ImgQuDataset(csv_path, img_dir, vocab, cfg)
        img_ids = ds.df["img_id"] if "img_id" in ds.df.columns else None
        if cfg.use_packed_cache:
            from zsgnet_tpu_torch.data.packed import PackedDataset

            h, w = cfg.resize_img
            ds = PackedDataset(ds, csv_dir / f"packed_{split}_{h}x{w}")
        if cfg.queries_per_img > 1:
            if img_ids is not None:
                ds = GroupedDataset(ds, img_ids, cfg.queries_per_img,
                                    reseed=cfg.grouped_reseed and split == "train")
            elif split == "train":
                raise ValueError("queries_per_img > 1 needs an img_id column")
        return BatchLoader(
            ds, cfg.bs, shuffle=shuffle, seed=cfg.seed, nw=cfg.nw, drop_last=drop_last,
            prefetch_depth=cfg.prefetch_depth, shard_id=shard_id, num_shards=num_shards,
        )

    train_dl = loader("train", shuffle=True, drop_last=True)
    valid_dl = loader("val", shuffle=False, drop_last=False)
    test_dl = loader(cfg.test_split, shuffle=False, drop_last=False)
    if train_dl is None or valid_dl is None:
        raise FileNotFoundError(f"missing train.csv/val.csv under {csv_dir}")
    return DataWrap(path=root, train_dl=train_dl, valid_dl=valid_dl, test_dl=test_dl, vocab=vocab)
