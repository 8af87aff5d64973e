"""Single-shot grounding inference — torch port of ``zsgnet_tpu/predict.py``.

``Grounder`` holds a model built from ``cfg``, a vocab and a port
``state_dict`` (or a checkpoint directory, ``Grounder.from_checkpoint``);
``ground(images, queries)`` pads each chunk of requests to the smallest
shape bucket that fits, runs the forward pass, decodes each row's
top-scored anchor (flat argmax, first of ties) and returns the box with
``sigmoid(score)``. ``ground_image(image, queries)`` grounds N queries
against one image with one backbone pass per chunk.

CLI:
    python -m zsgnet_tpu_torch.predict <ckpt_dir> <image> "<query>" [--key=val ...]

prints the predicted box in original-image pixels (x1 y1 x2 y2) and the
match score. Bulk mode streams a dataset-format CSV (``img_id``, ``query``;
box columns are ignored) to JSONL predictions:

    python -m zsgnet_tpu_torch.predict <ckpt_dir> --csv=split.csv
        --img_dir=images [--out=preds.jsonl] [--batch_size=32] [--grouped=false]

``--device`` (default ``cuda``) is where the model runs; ``--vocab=``,
``--oov_slots=N``, ``--glove=<file>`` and ``--quantize=true`` are as for
``Grounder``; every other ``--key=val`` overrides the checkpoint's
``cfg.json``.

``Grounder(devices=[...])`` serves data parallel, the JAX ``Grounder`` on a
1-D mesh: one replica of the weights on each listed device, every device
batch split into equal slices over the replicas.

``Grounder(mesh_spatial=S, devices=[...])`` serves spatially, the JAX
``Grounder`` on a ``(data, spatial)`` mesh: the devices (D·S of them,
data-major; they may repeat) form D groups of S members, each device batch
splits over the D groups only, and each group runs one forward with the
image height split over its members (``parallel.halo.LocalMesh``, one
thread a member). ``--mesh_spatial=N`` on the command line does the same.
"""

from __future__ import annotations

import copy
import json
import sys
import zlib
from collections import deque
from pathlib import Path

import numpy as np
import torch

from zsgnet_tpu_torch.config import Config, get_default_cfg
from zsgnet_tpu_torch.data.dataset import _load_image_u8
from zsgnet_tpu_torch.data.vocab import Vocab, tokenize
from zsgnet_tpu_torch.models.quant import quant_scales, set_quant_mode
from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for
from zsgnet_tpu_torch.parallel.halo import LocalMesh
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager, find_sidecar, load_sidecar_cfg
from zsgnet_tpu_torch.train.evaluator import decode_best_box
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor

# A partial chunk pads to the smallest of these below the batch size (or
# to the batch size itself).
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
# Chunks of at most this many rows go through the canvas head (the JAX
# package's measured crossover, zsgnet_tpu/predict.py).
LATENCY_BATCH_MAX = 16


def check_servable(cfg: Config, mesh_spatial: int | None = None) -> None:
    """Raise for a spatial split (``mesh_spatial``, default
    ``cfg.mesh_spatial``) that the image height does not divide into, as the
    JAX ``Grounder``'s height sharding refuses it."""
    sp = cfg.mesh_spatial if mesh_spatial is None else mesh_spatial
    if sp < 1 or cfg.resize_img[0] % sp:
        raise ValueError(f"mesh_spatial={sp} must divide the image height {cfg.resize_img[0]}")


def to_device(a: np.ndarray, device: torch.device) -> Tensor:
    """A host array on ``device``, through pinned memory without blocking
    on CUDA."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def load_image(im: str | Path | np.ndarray, resize_hw: tuple[int, int]) -> tuple[np.ndarray, tuple]:
    """A path (decoded and resized as the dataset does: native PNG/JPEG
    first, PIL for the rest) or an HWC uint8 array already at ``resize_hw``
    → (image, original (H, W))."""
    if isinstance(im, np.ndarray):
        arr = im.astype(np.uint8)
        if arr.shape[:2] != tuple(resize_hw):
            raise ValueError("array inputs must be pre-resized")
        return arr, (arr.shape[0], arr.shape[1])
    return _load_image_u8(Path(im), resize_hw)


def encode_queries(cfg: Config, vocab: Vocab, bs: int, queries: list[str]):
    """→ (qvec (bs, max_qlen) int32, qlens (bs,) int32). Pad rows get
    length 1, since packed sequences refuse length 0."""
    qvec = np.zeros((bs, cfg.max_qlen), np.int32)
    qlens = np.ones((bs,), np.int32)
    for j, q in enumerate(queries):
        qvec[j], qlens[j] = vocab.encode(q, cfg.max_qlen)
    return qvec, qlens


def prep_chunk(cfg: Config, vocab: Vocab, bs: int, images: list, queries: list):
    """Pad one request chunk to ``bs`` rows: (imgs u8, qvec, qlens, orig
    sizes, real count)."""
    imgs = np.zeros((bs, *cfg.resize_img, 3), np.uint8)
    sizes = np.ones((bs, 2), np.float32)
    for j, im in enumerate(images):
        imgs[j], sizes[j] = load_image(im, cfg.resize_img)
    qvec, qlens = encode_queries(cfg, vocab, bs, queries)
    return imgs, qvec, qlens, sizes, len(images)


def chunk_results(boxes, scores, sizes, k: int) -> list[dict]:
    """One padded chunk's output → per-request dicts (normalized tlbr,
    original-pixel xyxy, score)."""
    boxes = np.asarray(boxes)[:k]
    scores = np.asarray(scores)[:k]
    out: list[dict] = []
    for j in range(k):
        oh, ow = sizes[j]
        y1, x1, y2, x2 = boxes[j]
        out.append(
            {
                "box_norm": [float(v) for v in boxes[j]],
                "box_xyxy": [
                    float((x1 + 1) * ow / 2), float((y1 + 1) * oh / 2),
                    float((x2 + 1) * ow / 2), float((y2 + 1) * oh / 2),
                ],
                "score": float(scores[j]),
            }
        )
    return out


class OpenVocabMixin:
    """Open-vocabulary serving. ``oov_slots`` embedding rows reserved at load
    time go to unseen query words on first sight, first come first served:
    the word's GloVe row when ``glove_path`` has it, else a row drawn from
    a generator seeded with the word's CRC-32. Distinct unseen words so stay
    distinct instead of collapsing onto ``<unk>``; the rows are the JAX
    package's bit for bit. A row is written into ``embedding_table`` in
    place, on its device.

    The user class sets ``cfg``, ``vocab``, ``embedding_table``, ``oov_slots``,
    ``glove_path``, ``_glove_offsets``, ``_oov_warned``, ``_emb_scale`` and
    ``_vocab_rows``."""

    def _build_glove_index(self) -> None:
        """Scan ``glove_path`` once into a word → byte-offset index, so a
        later lookup is one seek and one line. Run at construction, not on
        the serving thread at the first unseen word."""
        offsets: dict[str, int] = {}
        off = 0
        with open(self.glove_path, "rb") as f:
            for line in f:
                tok = line.split(b" ", 1)[0].decode("utf-8", "replace")
                offsets.setdefault(tok, off)
                off += len(line)
        self._glove_offsets = offsets

    def _lookup_glove(self, word: str) -> np.ndarray | None:
        """The GloVe row of ``word``, or None."""
        if not self.glove_path:
            return None
        if self._glove_offsets is None:
            self._build_glove_index()
        off = self._glove_offsets.get(word)
        if off is None:
            return None
        with open(self.glove_path, "rb") as f:
            f.seek(off)
            parts = f.readline().decode("utf-8").rstrip().split(" ")
        if len(parts) < self.cfg.emb_dim + 1:
            return None  # a header or a malformed row
        return np.asarray(parts[1 : self.cfg.emb_dim + 1], np.float32)

    def _ensure_vocab(self, queries: list[str]) -> None:
        """Give unseen words of ``queries`` their reserved rows (no-op
        without ``oov_slots``)."""
        if not self.oov_slots:
            return
        weight = self.embedding_table
        for q in queries:
            # Tokens past max_qlen never reach the model: they take no slot.
            for w in tokenize(q)[: self.cfg.max_qlen]:
                if w in self.vocab.word_to_id:
                    continue
                if len(self.vocab) >= self._vocab_rows:
                    if not self._oov_warned:
                        print(f"{type(self).__name__}: all {self.oov_slots} OOV slots in use; "
                              "further unseen words fall back to <unk>")
                        self._oov_warned = True
                    continue
                idx = self.vocab.add_word(w)
                vec = self._lookup_glove(w)
                if vec is None:
                    rng = np.random.default_rng(zlib.crc32(w.encode()))
                    vec = rng.normal(0, self._emb_scale, weight.shape[1])
                with torch.no_grad():
                    weight[idx] = torch.from_numpy(vec.astype(np.float32))


class Grounder(OpenVocabMixin):
    """Load-once, call-many grounding predictor.

    The head and the number format follow the JAX ``Grounder``:

    * ``batch_size`` ≤ ``LATENCY_BATCH_MAX`` (16) with a shared head serves
      through the canvas head (``cfg.head_canvas``), and ignores
      ``quantize=True``;
    * above it, ``quantize=True`` (or ``cfg.quant_mode == "int8"``) serves
      int8, calibrated at ``calib@{quant_percentile}`` on the first batch
      that ``ground``/``ground_image`` sees, or by :meth:`calibrate`;
    * a float ``Grounder`` above it still serves its buckets of at most 16
      rows through the canvas head, the larger ones per level.

    Both heads are one set of parameters, so one model serves every bucket.

    ``ground`` keeps two chunks in flight: inputs go to the device from
    pinned memory without blocking, outputs stay there, and a chunk is read
    back only after the next two are queued, so the host decodes the next
    chunk's images while the device works.

    ``devices`` (in place of ``device``) serves data parallel: one replica of
    the weights on each device (a device may repeat), each device batch
    split into equal slices over them in order. ``batch_size`` and every
    bucket must divide over the replicas; ``ground_image`` takes the
    per-pair path, since one image does not split.

    ``mesh_spatial`` S > 1 serves each slice with its image height split
    over S members (the ``devices``, D·S of them, data-major; S copies of
    ``device`` by default): buckets divide over the D groups only, so
    bucket 1 serves at S = 2, its members all-gathering the height at the
    reshard (``parallel.halo.LocalSpatial``). ``ground_image`` takes the
    per-pair path. int8 calibrates on the unsharded model, and the members'
    convs take its scales by the global input shape (``parallel.halo.conv_rows``)."""

    def __init__(
        self, cfg: Config, vocab: Vocab, state_dict: dict[str, Tensor],
        batch_size: int = 8, bucket_sizes: tuple[int, ...] | None = None,
        oov_slots: int = 0, glove_path: str | Path | None = None,
        device: str | torch.device = "cuda", quantize: bool = False, quant_percentile: float = 0.999,
        devices: list | None = None, mesh_spatial: int = 1,
    ):
        self.spatial = int(mesh_spatial)
        if not devices:
            devices = [device] * self.spatial
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        check_servable(cfg, self.spatial)
        if len(self.devices) % self.spatial:
            raise ValueError(f"{len(self.devices)} devices do not form groups of mesh_spatial={self.spatial}")
        if batch_size <= LATENCY_BATCH_MAX and cfg.use_same_atb:
            cfg = cfg.replace(head_canvas=True)
        self.quantize = quantize or cfg.quant_mode == "int8"
        if self.quantize and cfg.head_canvas:
            if quantize:
                print("Grounder: quantize=True ignored at latency batch sizes "
                      f"(batch_size={batch_size} <= {LATENCY_BATCH_MAX} uses the canvas head; "
                      f"pass batch_size>{LATENCY_BATCH_MAX} for int8 throughput serving)")
            self.quantize = False
        cfg = cfg.replace(quant_mode="int8" if self.quantize else "off")
        self.quant_percentile = float(quant_percentile)
        self.cfg = cfg
        self.vocab = vocab
        self.bs = int(batch_size)
        n_shard = len(self.devices) // self.spatial  # buckets split over the data axis only
        if self.bs % n_shard:
            raise ValueError(f"batch_size={batch_size} must divide over the {n_shard}-device mesh")
        if bucket_sizes is None:
            bucket_sizes = tuple(b for b in BUCKETS if b < self.bs and b % n_shard == 0)
        elif any(b % n_shard for b in bucket_sizes):
            raise ValueError(f"bucket_sizes {bucket_sizes} must all divide over the {n_shard}-device mesh")
        # bucket_sizes=(batch_size,) pads every chunk to the full batch.
        self.bucket_sizes = tuple(sorted({*bucket_sizes, self.bs}))
        # A float Grounder above the latency sizes serves its small buckets
        # through the canvas head (the JAX Grounder's latency function).
        self.latency_canvas = (cfg.use_same_atb and not cfg.head_canvas and not self.quantize
                               and min(self.bucket_sizes) <= LATENCY_BATCH_MAX)
        self.oov_slots = int(oov_slots)
        self.glove_path = str(glove_path) if glove_path else None
        self._oov_warned = False
        self._glove_offsets: dict[str, int] | None = None
        self._vocab_rows = len(vocab) + self.oov_slots
        state_dict = {k: v for k, v in state_dict.items() if self.quantize or "_absmax_" not in k}
        if self.oov_slots:
            emb = state_dict["embedding.weight"].detach().cpu().float().numpy()
            if emb.shape[0] != len(vocab):
                raise ValueError(f"embedding table has {emb.shape[0]} rows for a {len(vocab)}-word "
                                 "vocab — cannot reserve OOV slots")
            # The scale of data/embeddings.py's rows for words without a vector.
            self._emb_scale = float(emb.std()) * 0.6 or 0.1
            state_dict["embedding.weight"] = torch.from_numpy(
                np.concatenate([emb, np.zeros((self.oov_slots, emb.shape[1]), np.float32)]))
            if self.glove_path:
                self._build_glove_index()
        self.model = ZSGNet(cfg, self._vocab_rows)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.anchors = torch.as_tensor(anchor_pyramid_for(cfg)).to(self.device)
        self._replicate()
        self.local_mesh = LocalMesh(self.devices, self.spatial) if self.spatial > 1 else None

    def _replicate(self) -> None:
        """The replicas of the other devices (or spatial members) as copies
        of ``model`` (and their anchors); none for one device."""
        self.replicas = [(self.model, self.anchors)] + [
            (copy.deepcopy(self.model).to(d), self.anchors.to(d)) for d in self.devices[1:]
        ]

    def _ensure_vocab(self, queries: list[str]) -> None:
        """As ``OpenVocabMixin._ensure_vocab``, with the new rows copied into
        every replica's embedding table."""
        n = len(self.vocab)
        super()._ensure_vocab(queries)
        if len(self.vocab) != n and len(self.replicas) > 1:
            with torch.no_grad():
                for m, _ in self.replicas[1:]:
                    m.embedding.weight.copy_(self.embedding_table)

    @property
    def embedding_table(self) -> Tensor:
        return self.model.embedding.weight

    @property
    def calibrated(self) -> bool:
        """An int8 Grounder has activation scales (from :meth:`calibrate`, its
        first batch, or the state_dict it was given)."""
        return bool(quant_scales(self.model))

    @classmethod
    def from_checkpoint(
        cls, ckpt_dir: str | Path, vocab_path: str | Path | None = None,
        cfg: Config | None = None, batch_size: int = 8, cfg_overrides: dict | None = None,
        oov_slots: int = 0, glove_path: str | Path | None = None,
        device: str | torch.device = "cuda", quantize: bool = False,
        bucket_sizes: tuple[int, ...] | None = None, devices: list | None = None,
        mesh_spatial: int = 1,
    ) -> "Grounder":
        """Serve the latest step of a checkpoint directory that the port's
        Learner (or ``convert``) wrote: the run's model directory or its
        ``best/`` store. The cfg and the vocab come from the ``cfg.json``
        and ``vocab.json`` beside it unless given; ``cfg`` replaces the
        sidecar, ``cfg_overrides`` patches keys on top. A checkpoint with
        ``ema`` (``cfg.ema_decay > 0``) serves the EMA parameters with the
        saved BatchNorm statistics. ``devices`` and ``mesh_spatial`` are as
        for the constructor."""
        if not devices:
            device = resolve_device(device)
        if cfg is None:
            cfg = load_sidecar_cfg(ckpt_dir)
            if cfg is None:
                print(f"Grounder: no cfg.json beside {ckpt_dir} — assuming the default architecture")
                cfg = get_default_cfg()
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        if vocab_path is None:
            vocab_path = find_sidecar(ckpt_dir, "vocab.json")
            if vocab_path is None:
                raise FileNotFoundError(f"no vocab.json beside {ckpt_dir}; pass vocab_path=")
        vocab = Vocab.load(vocab_path)
        payload = CheckpointManager(ckpt_dir).restore()
        state_dict = {**payload["model"], **payload.get("ema", {})}
        return cls(cfg, vocab, state_dict, batch_size, bucket_sizes, oov_slots=oov_slots,
                   glove_path=glove_path, device=device, quantize=quantize, devices=devices,
                   mesh_spatial=mesh_spatial)

    def warmup(self, multiquery: bool = False) -> None:
        """Run every shape bucket once now (and, with ``multiquery``, every
        ``ground_image`` bucket), so that no request pays a first call's
        set-up. Queries are ``<unk>``, which takes no OOV slot. An int8
        Grounder that is not calibrated yet skips: zeros would calibrate
        garbage scales. A data-parallel Grounder has no ``ground_image``
        buckets of its own (it grounds per pair)."""
        if self.quantize and not self.calibrated:
            print("Grounder.warmup: skipped — int8 serving calibrates on the first real batch; "
                  "warm up after .calibrate()/.ground()")
            return
        zero = np.zeros((*self.cfg.resize_img, 3), np.uint8)
        for b in self.bucket_sizes:
            self.ground([zero] * b, ["<unk>"] * b)
        if multiquery and len(self.replicas) == 1:
            for b in self.bucket_sizes:
                self.ground_image(zero, ["<unk>"] * b)

    @torch.inference_mode()
    def calibrate(self, img: np.ndarray, qvec: np.ndarray, qlens: np.ndarray) -> None:
        """Record every quantized conv's activation scales from one
        representative batch (running maxima), then serve int8."""
        set_quant_mode(self.model, f"calib@{self.quant_percentile}")
        try:
            self.model(self._to_device(img), self._to_device(qvec), torch.from_numpy(qlens))
        finally:
            set_quant_mode(self.model, "int8")
        if len(self.replicas) > 1:
            self._replicate()  # the scales are new buffers of the model

    def _to_device(self, a: np.ndarray) -> Tensor:
        return to_device(a, self.device)

    def canvas_for(self, pad_to: int) -> bool | None:
        """The head for a chunk padded to ``pad_to`` rows: the canvas for the
        small buckets of a float Grounder above the latency sizes, else
        the cfg's."""
        return True if self.latency_canvas and pad_to <= LATENCY_BATCH_MAX else None

    @torch.inference_mode()
    def _infer(self, img: Tensor, qvec: Tensor, qlens: Tensor) -> tuple[Tensor, Tensor]:
        """→ (boxes (B, 4), scores (B,)), left on the device: with replicas,
        each runs its slice of the rows on its device, and the slices come
        back to the first device in order."""
        canvas = self.canvas_for(qvec.shape[0])
        if self.local_mesh is not None:
            return self._infer_spatial(img, qvec, qlens, canvas)
        n = len(self.replicas)
        rows = qvec.shape[0] // n
        boxes, scores = [], []
        for i, (model, anchors) in enumerate(self.replicas):
            sl = slice(i * rows, (i + 1) * rows)
            dev = anchors.device
            out = model(img[sl].to(dev), qvec[sl].to(dev), qlens[sl], canvas=canvas)
            att = out["att_out"]
            boxes.append(decode_best_box(att, out["bbx_out"], anchors).to(self.device))
            scores.append(torch.sigmoid(att.max(dim=-1).values).to(self.device))
        if n == 1:
            return boxes[0], scores[0]
        return torch.cat(boxes), torch.cat(scores)

    def _infer_spatial(self, img: Tensor, qvec: Tensor, qlens: Tensor, canvas) -> tuple[Tensor, Tensor]:
        """``_infer`` over the spatial groups: group d takes slice d of the
        rows, and its member s the s-th band of their image rows, on its own
        device and thread. → the members' batch blocks in order (member 0's
        rows where the group gathered a batch below S)."""
        s = self.spatial
        rows = qvec.shape[0] // self.local_mesh.data

        def member(d: int, ctx) -> tuple[Tensor, Tensor]:
            model, anchors = self.replicas[d * s + ctx.index]
            sl = slice(d * rows, (d + 1) * rows)
            dev = anchors.device
            out = model(ctx.rows(img[sl]).to(dev), qvec[sl].to(dev), qlens[sl], canvas=canvas, spatial=ctx)
            att = out["att_out"]
            return (decode_best_box(att, out["bbx_out"], anchors).to(self.device),
                    torch.sigmoid(att.max(dim=-1).values).to(self.device))

        boxes, scores = [], []
        for group in self.local_mesh.run(member):
            parts = group if rows % s == 0 else group[:1]
            boxes.extend(b for b, _ in parts)
            scores.extend(sc for _, sc in parts)
        return torch.cat(boxes), torch.cat(scores)

    def _pad_to(self, k: int) -> int:
        return next(b for b in self.bucket_sizes if b >= k)

    def ground(self, images: list[str | Path | np.ndarray], queries: list[str]) -> list[dict]:
        """→ per pair: {"box_xyxy": pixel [x1, y1, x2, y2], "score": float,
        "box_norm": normalized tlbr}. Images are paths or HWC uint8 arrays
        already resized to ``cfg.resize_img``."""
        if len(images) != len(queries):
            raise ValueError("images and queries must pair up")
        self._ensure_vocab(queries)
        out: list[dict] = []
        in_flight: deque = deque()
        for start in range(0, len(images), self.bs):
            chunk = images[start : start + self.bs]
            imgs, qvec, qlens, sizes, k = prep_chunk(
                self.cfg, self.vocab, self._pad_to(len(chunk)), chunk,
                queries[start : start + self.bs],
            )
            if self.quantize and not self.calibrated:
                self.calibrate(imgs, qvec, qlens)
            boxes, scores = self._infer(self._to_device(imgs), self._to_device(qvec),
                                        torch.from_numpy(qlens))
            in_flight.append((boxes, scores, sizes, k))
            if len(in_flight) > 2:
                out.extend(read_results(*in_flight.popleft()))
        while in_flight:
            out.extend(read_results(*in_flight.popleft()))
        return out

    def ground_image(self, image: str | Path | np.ndarray, queries: list[str]) -> list[dict]:
        """Ground N queries against one image: one decode, and per chunk of
        queries (padded over the same buckets as ``ground``) one backbone
        pass at image batch 1 whose features the model expands to the
        queries. Equal to ``ground([image] * N, queries)``, which a
        data-parallel Grounder runs instead."""
        if not queries:
            return []
        if len(self.replicas) > 1:  # data parallel or spatial: per pair
            return self.ground([image] * len(queries), queries)
        self._ensure_vocab(queries)
        img, orig_hw = load_image(image, self.cfg.resize_img)
        img_dev = self._to_device(img[None].copy())
        out: list[dict] = []
        for start in range(0, len(queries), self.bs):
            chunk = queries[start : start + self.bs]
            pad_to = self._pad_to(len(chunk))
            qvec, qlens = encode_queries(self.cfg, self.vocab, pad_to, chunk)
            if self.quantize and not self.calibrated:
                self.calibrate(img[None].copy(), qvec, qlens)
            boxes, scores = self._infer(img_dev, self._to_device(qvec), torch.from_numpy(qlens))
            sizes = np.tile(np.asarray(orig_hw, np.float32), (pad_to, 1))
            out.extend(read_results(boxes, scores, sizes, len(chunk)))
        return out


def read_results(boxes: Tensor, scores: Tensor, sizes: np.ndarray, k: int) -> list[dict]:
    """One chunk's outputs, read back from the device → per-request dicts."""
    return chunk_results(boxes.cpu().numpy(), scores.cpu().numpy(), sizes, k)


def batch_predict(
    grounder: Grounder, csv_path: str | Path, img_dir: str | Path,
    out_path: str | Path, block_batches: int = 4, grouped: bool = True,
) -> int:
    """Bulk inference: a dataset-format CSV (``img_id`` relative to
    ``img_dir``, ``query``; other columns ignored) → JSONL, one line per
    row in CSV order with ``img_id``, ``query``, ``box_xyxy``, ``box_norm``
    and ``score``. Rows go in blocks of ``block_batches`` batches. With
    ``grouped``, an image with two or more phrases in a block goes through
    ``ground_image`` (one decode, one backbone pass), and single-phrase rows
    batch through ``ground``; the results equal the flat path's. Returns
    the number of rows written."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    missing = {"img_id", "query"} - set(df.columns)
    if missing:
        raise ValueError(f"{csv_path}: CSV is missing columns {sorted(missing)}")
    img_dir = Path(img_dir)
    span = block_batches * grounder.bs
    n = 0
    with open(out_path, "w") as f:
        for start in range(0, len(df), span):
            rows = df.iloc[start : start + span]
            ids = [str(p) for p in rows["img_id"]]
            paths = [img_dir / p for p in ids]
            queries = [str(q) for q in rows["query"]]
            if grouped:
                results: list = [None] * len(rows)
                by_img: dict[str, list[int]] = {}
                for j, p in enumerate(ids):
                    by_img.setdefault(p, []).append(j)
                flat = [g[0] for g in by_img.values() if len(g) == 1]
                for j, res in zip(flat, grounder.ground([paths[j] for j in flat],
                                                        [queries[j] for j in flat])):
                    results[j] = res
                for g in by_img.values():
                    if len(g) > 1:
                        for j, res in zip(g, grounder.ground_image(paths[g[0]], [queries[j] for j in g])):
                            results[j] = res
            else:
                results = grounder.ground(paths, queries)
            for img_id, query, res in zip(ids, queries, results):
                f.write(json.dumps({"img_id": img_id, "query": query, **res}) + "\n")
                n += 1
    return n


def is_true(flag: str) -> bool:
    return flag.lower() in ("1", "true", "yes")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    overrides = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    kw = dict(
        quantize=is_true(overrides.pop("quantize", "false")),
        vocab_path=overrides.pop("vocab", None),
        oov_slots=int(overrides.pop("oov_slots", "0")),
        glove_path=overrides.pop("glove", None),
        device=overrides.pop("device", "cuda"),
        mesh_spatial=int(overrides.pop("mesh_spatial", "1")),
    )
    csv_path = overrides.pop("csv", None)
    if csv_path is not None:
        if len(args) != 1:
            raise SystemExit(__doc__)
        img_dir = overrides.pop("img_dir", ".")
        out_path = overrides.pop("out", "predictions.jsonl")
        bs = int(overrides.pop("batch_size", "32"))
        grouped = is_true(overrides.pop("grouped", "true"))
        g = Grounder.from_checkpoint(args[0], batch_size=bs, cfg_overrides=overrides or None, **kw)
        n = batch_predict(g, csv_path, img_dir, out_path, grouped=grouped)
        print(f"wrote {n} predictions → {out_path}")
        return
    if len(args) != 3:
        raise SystemExit(__doc__)
    ckpt_dir, image, query = args
    g = Grounder.from_checkpoint(ckpt_dir, batch_size=1, cfg_overrides=overrides or None, **kw)
    (res,) = g.ground([image], [query])
    x1, y1, x2, y2 = res["box_xyxy"]
    print(f"{x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f}  score={res['score']:.4f}")


if __name__ == "__main__":
    main()
