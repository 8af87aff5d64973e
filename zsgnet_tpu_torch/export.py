"""Serving export — a ``Grounder`` → a directory of ``torch.export``
programs, and ``ExportedGrounder`` to serve it. Port of
``zsgnet_tpu/export.py``.

Each program is the whole serving function (uint8 preprocessing,
backbone, fusion, head and the top-anchor decode) traced once by
``torch.export`` and saved with ``torch.export.save``. A program exported
on one device runs there, so ``platforms`` writes one set per device, each
under its own subdirectory. Layout::

    export.json          cfg, batch size, platforms, version, "format": "torch.export"
    vocab.json           the query vocabulary
    <platform>/serving_fn.pt2          version 1: one batch size, weights inside
    <platform>/serving_fn_b{N}.pt2     version 2 (``bucket_sizes``): one per bucket
    <platform>/serving_mq_b{N}.pt2     ``multiquery``: one image against N queries
    weights.npz          version 3 (``weights_as_args``): the state_dict, shared

Version 3 programs take the weights as their first input, so one
``weights.npz`` serves every bucket, and the embedding table being an
input, ``ExportedGrounder`` gives unseen words their reserved rows as the
live ``Grounder`` does (``oov_slots``). Buckets of at most 16 rows take the
canvas head where the live ``Grounder`` would. int8 programs carry the
calibrated scales, so only a calibrated ``Grounder`` exports int8.

The packed cuDNN LSTM takes its lengths on the host, which ``torch.export``
cannot trace; the programs encode queries with the masked scan
(``models.bilstm.encode_query_masked``), the same function.

The JAX package's artifacts (StableHLO, no ``format`` key) are refused
here; its loader stops on this layout, finding no ``serving_fn*.stablehlo``.

``ExportedGrounder.load(data_parallel=True)`` serves an artifact on every
local device of the requested type (or on ``devices``): whole device
batches go round-robin over the devices, each with its own copy of the
programs and of the version 3 weights, as the JAX package's loader does.

CLI:
    python -m zsgnet_tpu_torch.export <ckpt_dir> <out_dir> [--batch_size=8]
        [--platforms=cuda,cpu] [--quantize=true] [--bucket_sizes=1,4,8]
        [--weights_as_args=true [--oov_slots=64]] [--multiquery=true]
        [--device=cuda] [--key=val ...]
"""

from __future__ import annotations

import copy
import json
import sys
from collections import deque
from pathlib import Path

import numpy as np
import torch
from torch import nn

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.parallel.mesh import local_devices
from zsgnet_tpu_torch.predict import (
    Grounder, OpenVocabMixin, encode_queries, is_true, load_image, prep_chunk, read_results, to_device,
)
from zsgnet_tpu_torch.train.evaluator import decode_best_box
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor

ARTIFACT_VERSION = 1  # one program: serving_fn.pt2
BUCKETED_VERSION = 2  # one program per batch bucket: serving_fn_b{N}.pt2
WEIGHTS_AS_ARGS_VERSION = 3  # programs take the weights; weights.npz holds them once
FORMAT = "torch.export"


class ServingFn(nn.Module):
    """(uint8 images, qvec, qlens) → (boxes (B, 4), scores (B,)), the
    live ``Grounder._infer`` with the head fixed (``canvas``) and the masked
    query encoder."""

    def __init__(self, model: nn.Module, anchors: Tensor, canvas: bool | None):
        super().__init__()
        self.model, self.anchors, self.canvas = model, anchors, canvas

    def forward(self, img: Tensor, qvec: Tensor, qlens: Tensor) -> tuple[Tensor, Tensor]:
        out = self.model(img, qvec, qlens, canvas=self.canvas, packed_lstm=False)
        att = out["att_out"]
        return decode_best_box(att, out["bbx_out"], self.anchors), torch.sigmoid(att.max(dim=-1).values)


class WeightsAsArgs(nn.Module):
    """A ``ServingFn`` whose model weights are its first input (version 3)."""

    def __init__(self, fn: ServingFn):
        super().__init__()
        self.fn = fn

    def forward(self, weights: dict[str, Tensor], img: Tensor, qvec: Tensor, qlens: Tensor):
        return torch.func.functional_call(self.fn, weights, (img, qvec, qlens))


def _weights(model: nn.Module) -> dict[str, Tensor]:
    """The state_dict as ``ServingFn``'s parameter names."""
    return {f"model.{k}": v for k, v in model.state_dict().items()}


def _shell(model: nn.Module) -> nn.Module:
    """A copy of ``model`` whose parameters and state_dict buffers are
    empty, so that a version 3 program, which reads them from its weights
    input, does not carry them too."""
    shell = copy.deepcopy(model)
    for m in shell.modules():
        for name, p in m._parameters.items():
            if p is not None:
                m._parameters[name] = nn.Parameter(p.new_empty(0), requires_grad=False)
        for name, b in m._buffers.items():
            if b is not None and name not in m._non_persistent_buffers_set:
                m._buffers[name] = b.new_empty(0)
    return shell


def export_serving(
    grounder: Grounder, out_dir: str | Path, platforms: tuple[str, ...] = ("cuda",),
    bucket_sizes: tuple[int, ...] | None = None, weights_as_args: bool = False, multiquery: bool = False,
) -> Path:
    """Write ``grounder``'s serving function as ``torch.export`` programs
    into ``out_dir`` (layout in the module docstring) and return it.
    ``bucket_sizes`` (with the batch size) exports one program per bucket;
    ``multiquery`` one image-against-N-queries program per bucket (the
    live ``ground_image``); ``weights_as_args`` writes version 3."""
    if grounder.quantize and not grounder.calibrated:
        raise ValueError("int8 Grounder is uncalibrated — call .calibrate() (or .ground() once on "
                         "representative data) before export; the activation scales go into the artifact")
    cfg, bs = grounder.cfg, grounder.bs
    h, w = cfg.resize_img
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    buckets = [bs] if bucket_sizes is None else sorted({*(int(b) for b in bucket_sizes), bs})
    meta = {
        "version": ARTIFACT_VERSION if bucket_sizes is None else BUCKETED_VERSION,
        "format": FORMAT,
        "torch_version": torch.__version__,
        "cfg": cfg.to_dict(),
        "batch_size": bs,
        "platforms": [resolve_device(p).type for p in platforms],
        "quantized": bool(grounder.quantize),
    }
    if bucket_sizes is not None:
        meta["bucket_sizes"] = buckets
    if multiquery:
        meta["multiquery_buckets"] = buckets
    if weights_as_args:
        meta.update(version=WEIGHTS_AS_ARGS_VERSION, weights_as_args=True, oov_slots=grounder.oov_slots)
        if grounder.oov_slots:
            meta["emb_scale"] = float(grounder._emb_scale)
        np.savez(out / "weights.npz", **{k: v.detach().cpu().numpy() for k, v in _weights(grounder.model).items()})
    for dev in map(resolve_device, platforms):
        model = copy.deepcopy(grounder.model).to(dev).eval()
        anchors = grounder.anchors.to(dev)
        (out / dev.type).mkdir(exist_ok=True)
        jobs = [("serving_fn" if bucket_sizes is None else f"serving_fn_b{b}", b, b) for b in buckets]
        jobs += [(f"serving_mq_b{b}", b, 1) for b in buckets] if multiquery else []
        for name, b, n_img in jobs:
            args = (torch.zeros((n_img, h, w, 3), dtype=torch.uint8, device=dev),
                    torch.ones((b, cfg.max_qlen), dtype=torch.int32, device=dev),
                    torch.ones((b,), dtype=torch.int32, device=dev))
            fn = ServingFn(model, anchors, grounder.canvas_for(b))
            with torch.no_grad():
                fn(*args)  # fills the head's grid or canvas constants outside the trace
            if weights_as_args:
                fn, args = WeightsAsArgs(ServingFn(_shell(model), anchors, fn.canvas)), (_weights(model), *args)
            # Lowered to ATen ops: autocast becomes explicit casts, not a region
            # that the loaded program re-enters with autocast on.
            ep = torch.export.export(fn, args, strict=False).run_decompositions()
            ep.example_inputs = None  # a version 3 program would otherwise save the weights it was traced with
            torch.export.save(ep, out / dev.type / f"{name}.pt2")
    (out / "export.json").write_text(json.dumps(meta, indent=2, default=list))
    grounder.vocab.save(out / "vocab.json")
    return out


class ExportedGrounder(OpenVocabMixin):
    """Serve an exported artifact with the live ``Grounder``'s surface
    (``ground``, ``ground_image``, ``warmup``, ``bs``, ``bucket_sizes``,
    ``cfg``, ``vocab``) and its pre- and post-processing, so the two give
    the same answers. Version 3 artifacts exported with ``oov_slots`` keep
    giving unseen words their rows."""

    def __init__(self, calls: dict, cfg: Config, vocab: Vocab, batch_size: int, device: torch.device,
                 weights: dict[str, Tensor] | None = None, meta: dict | None = None,
                 glove_path: str | Path | None = None, mq_calls: dict | None = None,
                 devices: list | None = None):
        self.cfg, self.vocab, self.bs, self.device = cfg, vocab, batch_size, device
        self.bucket_sizes = tuple(sorted(calls))
        self._calls, self._mq_calls = calls, mq_calls or {}
        self.weights = weights
        # Round-robin data parallel: the programs and weights of each device,
        # made at first use there; how many chunks each device took.
        self._devices = [torch.device(d) for d in devices] if devices else None
        self._placed: dict[torch.device, tuple] = {device: (calls, self._mq_calls, weights)}
        self._rr = 0
        self.dispatch_counts: dict[torch.device, int] = {}
        meta = meta or {}
        self.oov_slots = int(meta.get("oov_slots", 0)) if weights is not None else 0
        self.glove_path = str(glove_path) if (glove_path and self.oov_slots) else None
        self._oov_warned = False
        self._glove_offsets: dict[str, int] | None = None
        self._vocab_rows = len(vocab)
        if self.oov_slots:
            self._vocab_rows = self.embedding_table.shape[0]
            self._emb_scale = float(meta.get("emb_scale", 0.1))
            if len(vocab) > self._vocab_rows:
                raise ValueError(f"vocab.json has {len(vocab)} words but the exported table has "
                                 f"{self._vocab_rows} rows")
            if self.glove_path:
                self._build_glove_index()

    @property
    def embedding_table(self) -> Tensor:
        return self.weights["model.embedding.weight"]

    @classmethod
    def load(cls, artifact_dir: str | Path, glove_path: str | Path | None = None,
             device: str | torch.device = "cuda", data_parallel: bool = False,
             devices: list | None = None) -> "ExportedGrounder":
        """Load the programs exported for ``device``'s type. With
        ``data_parallel`` (every local device of that type) or ``devices``,
        whole device batches go round-robin over the devices; one device
        serves as the plain path does."""
        if devices:
            devices = [resolve_device(d) for d in devices]
        elif data_parallel:
            devices = local_devices(device)
        device = devices[0] if devices else resolve_device(device)
        devices = devices if devices and len(devices) > 1 else None
        d = Path(artifact_dir)
        meta = json.loads((d / "export.json").read_text())
        if meta.get("format") != FORMAT:
            raise ValueError(f"{d} is not a {FORMAT} artifact (format {meta.get('format')!r}, version "
                             f"{meta.get('version')}): a StableHLO artifact of the JAX package loads with "
                             "that package's ExportedGrounder")
        if meta["version"] not in (ARTIFACT_VERSION, BUCKETED_VERSION, WEIGHTS_AS_ARGS_VERSION):
            raise ValueError(f"unsupported artifact version {meta['version']}")
        if device.type not in meta["platforms"]:
            raise ValueError(f"{d} holds programs for {meta['platforms']}, not {device.type}")
        sub = d / device.type

        def program(name: str):
            return torch.export.load(sub / f"{name}.pt2").module()

        if "bucket_sizes" in meta:
            calls = {b: program(f"serving_fn_b{b}") for b in meta["bucket_sizes"]}
        else:
            calls = {meta["batch_size"]: program("serving_fn")}
        mq_calls = {b: program(f"serving_mq_b{b}") for b in meta.get("multiquery_buckets", ())}
        weights = None
        if meta.get("weights_as_args"):
            with np.load(d / "weights.npz") as z:
                weights = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
        cfg = Config().replace(**meta["cfg"])
        return cls(calls, cfg, Vocab.load(d / "vocab.json"), meta["batch_size"], device, weights=weights,
                   meta=meta, glove_path=glove_path, mq_calls=mq_calls, devices=devices)

    def warmup(self, multiquery: bool = False) -> None:
        """Run every program once on every device (see ``Grounder.warmup``)."""
        zero = np.zeros((*self.cfg.resize_img, 3), np.uint8)
        reps = len(self._devices) if self._devices else 1
        for b in self.bucket_sizes:
            for _ in range(reps):
                self.ground([zero] * b, ["<unk>"] * b)
        if multiquery:
            for b in sorted(self._mq_calls):
                for _ in range(reps):
                    self.ground_image(zero, ["<unk>"] * b)

    def _ensure_vocab(self, queries: list[str]) -> None:
        """As ``OpenVocabMixin._ensure_vocab``; the other devices' weights
        are placed anew at their next chunk."""
        n = len(self.vocab)
        super()._ensure_vocab(queries)
        if len(self.vocab) != n:
            self._placed = {self.device: self._placed[self.device]}

    def _next_device(self) -> torch.device:
        """The device of the next chunk: round-robin under data parallel."""
        if not self._devices:
            return self.device
        dev = self._devices[self._rr % len(self._devices)]
        self._rr += 1
        self.dispatch_counts[dev] = self.dispatch_counts.get(dev, 0) + 1
        return dev

    def _on(self, dev: torch.device) -> tuple:
        """(calls, multi-query calls, weights) on ``dev``: the loaded
        programs moved there and the weights copied, once."""
        if dev not in self._placed:
            move = lambda calls: {b: copy.deepcopy(f).to(dev) for b, f in calls.items()}  # noqa: E731
            weights = None if self.weights is None else {k: v.to(dev) for k, v in self.weights.items()}
            self._placed[dev] = (move(self._calls), move(self._mq_calls), weights)
        return self._placed[dev]

    @torch.no_grad()
    def _call(self, mq: bool, pad_to: int, img: np.ndarray, qvec: np.ndarray, qlens: np.ndarray):
        """One chunk's program on the next device → (boxes, scores) there."""
        dev = self._next_device()
        calls, mq_calls, weights = self._on(dev)
        args = (to_device(img, dev), to_device(qvec, dev), to_device(qlens, dev))
        if weights is not None:
            args = (weights, *args)
        return (mq_calls if mq else calls)[pad_to](*args)

    def ground(self, images: list, queries: list[str]) -> list[dict]:
        """As ``Grounder.ground``."""
        if len(images) != len(queries):
            raise ValueError("images and queries must pair up")
        self._ensure_vocab(queries)
        out: list[dict] = []
        in_flight: deque = deque()
        for start in range(0, len(images), self.bs):
            chunk = images[start : start + self.bs]
            pad_to = next(b for b in self.bucket_sizes if b >= len(chunk))
            imgs, qvec, qlens, sizes, k = prep_chunk(self.cfg, self.vocab, pad_to, chunk,
                                                     queries[start : start + self.bs])
            boxes, scores = self._call(False, pad_to, imgs, qvec, qlens)
            in_flight.append((boxes, scores, sizes, k))
            if len(in_flight) > 2:
                out.extend(read_results(*in_flight.popleft()))
        while in_flight:
            out.extend(read_results(*in_flight.popleft()))
        return out

    def ground_image(self, image, queries: list[str]) -> list[dict]:
        """As ``Grounder.ground_image``: one backbone pass per chunk with the
        multi-query programs, else the per-pair path (same answers)."""
        if not queries:
            return []
        if not self._mq_calls:
            return self.ground([image] * len(queries), queries)
        self._ensure_vocab(queries)
        img, orig_hw = load_image(image, self.cfg.resize_img)
        img = img[None].copy()
        buckets = sorted(self._mq_calls)
        out: list[dict] = []
        for start in range(0, len(queries), buckets[-1]):
            chunk = queries[start : start + buckets[-1]]
            pad_to = next(b for b in buckets if b >= len(chunk))
            qvec, qlens = encode_queries(self.cfg, self.vocab, pad_to, chunk)
            boxes, scores = self._call(True, pad_to, img, qvec, qlens)
            out.extend(read_results(boxes, scores, np.tile(np.asarray(orig_hw, np.float32), (pad_to, 1)), len(chunk)))
        return out


def main(argv: list[str] | None = None) -> Path:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    overrides = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if len(args) != 2:
        raise SystemExit(__doc__)
    ckpt_dir, out_dir = args
    buckets = overrides.pop("bucket_sizes", None)
    platforms = tuple(overrides.pop("platforms", "cuda").split(","))
    waa = is_true(overrides.pop("weights_as_args", "false"))
    mq = is_true(overrides.pop("multiquery", "false"))
    oov_slots = int(overrides.pop("oov_slots", "0"))
    if oov_slots and not waa:
        raise SystemExit("--oov_slots requires --weights_as_args=true (v3): baked-weight programs "
                         "hold the embedding table inside")
    g = Grounder.from_checkpoint(
        ckpt_dir, overrides.pop("vocab", None), batch_size=int(overrides.pop("batch_size", "8")),
        quantize=is_true(overrides.pop("quantize", "false")), oov_slots=oov_slots,
        device=overrides.pop("device", platforms[0]), cfg_overrides=overrides or None,
    )
    if g.quantize and not g.calibrated:
        raise SystemExit("--quantize export needs calibration data; serve one batch through "
                         "Grounder.ground()/calibrate() in Python, then call export_serving()")
    path = export_serving(g, out_dir, platforms=platforms,
                          bucket_sizes=tuple(int(b) for b in buckets.split(",")) if buckets else None,
                          weights_as_args=waa, multiquery=mq)
    n = sum(p.stat().st_size for p in path.glob("*/serving_*.pt2"))
    wn = (path / "weights.npz").stat().st_size if waa else 0
    print(f"exported {platforms} serving artifact → {path} ({n / 1e6:.1f} MB programs"
          + (f" + weights.npz {wn / 1e6:.1f} MB)" if wn else ")"))
    return path


if __name__ == "__main__":
    main()
