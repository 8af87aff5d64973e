"""Learner — port of ``zsgnet_tpu/train/learner.py``.

``Learner(uid, data, cfg, device="cuda").fit(epochs, lr)`` trains with
``make_train_step``, validates every epoch, logs one JSON row per epoch
under ``<tmp_path>/logs/<uid>.jsonl``, and checkpoints under
``<tmp_path>/models/<uid>/``: a rotating store of the latest steps and a
single-slot ``best/`` store for the best validation Acc, with ``cfg.json``
and ``vocab.json`` beside them. It keeps the JAX Learner's semantics:

* ``fit(epochs)`` trains until ``epoch == epochs`` (a resumed Learner runs
  what is left of the budget); ``fit(e, lr)`` changes ``lr_scale`` and
  keeps the optimizer's moments;
* ``cfg.ckpt_every_steps`` saves the position inside the epoch, and a
  resumed ``fit`` skips the batches already trained; ``request_stop``
  saves that position and returns at the next batch;
* ``cfg.use_reduce_lr_plateau`` lowers ``lr_scale`` on a plateau of the
  validation Acc;
* with ``cfg.ema_decay > 0`` validation runs the EMA parameters with the
  live BatchNorm statistics;
* ``cfg.glove_path`` initializes the embedding from a GloVe file
  (``data/embeddings.py``) before the optimizer and the EMA are made.

* with ``cfg.queries_per_img`` Q > 1 (grouped batches of images with Q
  phrases each) validation counts every real pair once: a pair counts when
  its unit is real (``valid``) and it is not a wrap-repeat inside its unit
  (``pair_valid``), so the metrics equal the flat loader's; ``qps`` counts
  pairs.

* with ``cfg.use_tensorboard`` every JSONL row is also written as
  TensorBoard scalars under ``<tmp_path>/logs/tb/<uid>`` through
  ``tensorboardX``, or ``torch.utils.tensorboard`` without it, when one is
  installed (never a hard dependency).

* with ``cfg.do_dist`` and a process group up (``parallel.mesh``), or an
  explicit ``mesh``, it trains data parallel: the loaders hold this rank's
  shard of every global batch, the model takes its BatchNorm moments over
  every rank (``cfg.bn_sync_axis``), the steps sum gradients and losses
  over the ranks, and validation gathers every rank's per-sample metrics
  and metadata in rank order, so every rank summarizes the same global
  numbers and takes the same plateau decisions. Parameters start equal on
  every rank (a seeded init on the CPU, or the same checkpoint). Rank 0
  alone writes the log, the TensorBoard rows, the prediction dumps and the
  checkpoints while the others wait at a barrier; a stop requested on any
  rank stops every rank at the same batch.

* with ``cfg.mesh_spatial`` S > 1 the mesh is the 2-D ``(data, spatial)``
  grid of ``parallel.mesh.make_mesh`` (one process per member, launched
  with ``torch.distributed.run --nproc_per_node=D·S``): the loaders hold the
  data index's shard, every member of a spatial group the same one, and
  the steps run the halo step (``parallel/train_step.py``). Validation
  gathers each rank's block of its shard, which in rank order is the
  global batch; a shard that the S members do not divide (one sample per
  data index) is gathered within the group, and only its member 0 reports
  its rows, so each pair counts once. As in the JAX Learner the train step
  is built at first use, so under ``spatial_mode='gspmd'`` a retina
  Learner validates and only ``train_step`` raises.

The loss is read back from the device every ``cfg.log_every`` steps, one
interval late, so the loop never waits on the device for it.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data.dataset import DataWrap
from zsgnet_tpu_torch.data.embeddings import load_embedding_table
from zsgnet_tpu_torch.models.bilstm import fold_lstm_bias_
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
from zsgnet_tpu_torch.parallel import mesh as mesh_lib
from zsgnet_tpu_torch.parallel.halo import group_spatial
from zsgnet_tpu_torch.parallel.mesh import DataMesh
from zsgnet_tpu_torch.parallel.train_step import (
    create_train_state,
    lr_schedule_scale,
    make_eval_step,
    make_train_step,
)
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager, partial_load
from zsgnet_tpu_torch.train.evaluator import Evaluator
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor


class SmoothenValue:
    """Bias-corrected EMA of a scalar (the smoothed training loss)."""

    def __init__(self, beta: float = 0.9):
        self.beta, self.n, self.mov_avg = beta, 0, 0.0
        self.smooth = 0.0

    def add_value(self, val: float) -> None:
        self.n += 1
        self.mov_avg = self.beta * self.mov_avg + (1 - self.beta) * val
        self.smooth = self.mov_avg / (1 - self.beta ** self.n)


class PlateauScheduler:
    """ReduceLROnPlateau on the per-epoch validation metric (mode 'max'):
    after more than ``patience`` epochs in a row without an improvement
    beyond ``threshold``, the LR multiplier drops by ``factor``."""

    def __init__(self, factor: float = 0.1, patience: int = 2,
                 threshold: float = 1e-4, min_scale: float = 1e-8):
        self.factor, self.patience = factor, patience
        self.threshold, self.min_scale = threshold, min_scale
        self.best = float("-inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric > self.best + self.threshold:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.num_bad = 0
        return self.scale


class _LateLosses:
    """A loss dict copied to the host without waiting; read it later."""

    def __init__(self, ls: dict[str, Tensor]):
        self.host = {k: v.detach().to("cpu", non_blocking=True) for k, v in ls.items()}
        self.done = None
        if any(v.is_cuda for v in ls.values()):
            self.done = torch.cuda.Event()
            self.done.record()

    def read(self) -> dict[str, float]:
        if self.done is not None:
            self.done.synchronize()
        return {k: float(v) for k, v in self.host.items()}


class Learner:
    def __init__(self, uid: str, data: DataWrap, cfg: Config, device: str | torch.device = "cuda",
                 mesh: DataMesh | None = None):
        self.device = resolve_device(device)
        if mesh is None and (cfg.do_dist or cfg.mesh_spatial > 1) and dist.is_available() and dist.is_initialized():
            mesh = mesh_lib.make_mesh(cfg, self.device)
        if cfg.mesh_spatial > 1 and (mesh is None or mesh.spatial != cfg.mesh_spatial):
            raise RuntimeError(f"mesh_spatial={cfg.mesh_spatial} runs one process per member: launch "
                               "python -m torch.distributed.run --nproc_per_node=D·S so that a process group "
                               "is up, or pass its mesh=")
        self.mesh = mesh
        self._spatial = group_spatial(mesh)
        self.is_main = mesh is None or mesh.rank == 0
        shards = mesh.data_size if mesh is not None else 1
        if data.train_dl.num_shards != shards:
            raise ValueError(f"the loaders hold 1/{data.train_dl.num_shards} of each batch but the data "
                             f"mesh has {shards} data index(es): get_data(cfg, *parallel.mesh.data_shard(cfg))")
        self.uid = uid
        self.data = data
        if cfg.lr_schedule != "const" and cfg.lr_decay_steps == 0:
            # The default decay horizon is the whole configured run.
            cfg = cfg.replace(lr_decay_steps=cfg.epochs * len(data.train_dl))
        self.cfg = cfg

        tmp = Path(cfg.tmp_path)
        self.log_dir = tmp / "logs"
        self.model_dir = tmp / "models" / uid
        self.pred_dir = tmp / "predictions"
        for d in (self.log_dir, self.model_dir, self.pred_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.log_file = self.log_dir / f"{uid}.jsonl"
        self._tb = None  # the SummaryWriter class, with cfg.use_tensorboard, on rank 0
        if cfg.use_tensorboard and self.is_main:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                try:  # the same event files, through the tensorboard package
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError as e:
                    SummaryWriter = None
                    print(f"use_tensorboard: no TensorBoard rows ({e}); the JSONL log is written")
            self._tb = SummaryWriter

        # Under a data mesh the model's BatchNorm moments are global (the
        # JAX Learner's bn_sync_axis); cfg.json keeps the run's cfg.
        model_cfg = cfg.replace(bn_sync_axis=cfg.data_axis) if mesh is not None else cfg
        self.model = get_default_net(model_cfg, len(data.vocab), seed=cfg.seed, device=self.device)
        if cfg.glove_path:
            table, found = load_embedding_table(cfg.glove_path, data.vocab, cfg.emb_dim, cfg.seed)
            with torch.no_grad():
                self.model.embedding.weight.copy_(torch.from_numpy(table))
            self._print(f"glove init: {found}/{len(data.vocab)} vocab words found")
        self.anchors = anchor_pyramid_for(cfg)
        self.state = create_train_state(cfg, self.model)
        self._train_step = None  # built at first use
        self._stop_requested = False
        self._epoch_batches = 0
        self._resume_batches = 0
        self._sidecars_written = False
        self.eval_step = make_eval_step(cfg, self.anchors, self.device, self.mesh)
        self.ckpt = CheckpointManager(self.model_dir)
        # Best-by-val-Acc lives in its own single-slot store, so the
        # rotation of the latest steps never removes it.
        self.ckpt_best = CheckpointManager(self.model_dir / "best", max_to_keep=1)
        self.plateau = PlateauScheduler(cfg.plateau_factor, cfg.plateau_patience)
        self.best_metric = -1.0
        self.epoch = 0
        if cfg.resume:
            # Evaluation-only runs load the best weights; training resumes
            # from the latest step.
            self.load_model_dict(
                cfg.resume_path or None, strict=cfg.load_normally,
                prefer_best=cfg.only_val or cfg.only_test,
            )

    # ------------------------------------------------------------------
    @property
    def train_step(self):
        if self._train_step is None:
            self._train_step = make_train_step(self.cfg, self.anchors, self.device, self.mesh)
        return self._train_step

    def request_stop(self) -> None:
        """Ask ``fit`` to stop at the next batch boundary: it checkpoints the
        position inside the epoch and returns, and a resumed ``fit`` goes on
        from there. Safe from a signal handler (a bool store). Under a data
        mesh the ranks agree after every batch, so a request on any rank
        stops them all at the same batch."""
        self._stop_requested = True

    def _stop_agreed(self) -> bool:
        """Whether to stop after this batch: the local request, or any
        rank's under a data mesh of more than one rank."""
        if self.mesh is None or self.mesh.world_size == 1:
            return self._stop_requested
        return mesh_lib.any_rank(self._stop_requested, self.mesh)

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg)

    # ------------------------------------------------------------------
    def fit(self, epochs: int | None = None, lr: float | None = None) -> None:
        """Train until ``self.epoch == epochs`` (``cfg.epochs`` by default):
        ``epochs`` is the total budget, so a Learner resumed at epoch 7 runs
        3 more epochs of ``fit(10)``. ``lr`` sets the effective learning rate
        through ``lr_scale`` and keeps the optimizer's moments; earlier
        plateau reductions are absorbed into the new scale."""
        cfg = self.cfg
        if lr is not None:
            scale = float(lr) / cfg.lr
            if abs(self.state.lr_scale - scale) > 1e-12:
                self.state.lr_scale = scale
                self.plateau.scale = scale
                self._print(f"fit: lr → {lr:g} via lr_scale={scale:g} "
                            "(optimizer moments preserved; plateau continues from it)")
        epochs = epochs or cfg.epochs
        n_batches_epoch = len(self.data.train_dl)
        if cfg.lr_schedule != "const" and cfg.lr_decay_steps > 0:
            total_steps = epochs * n_batches_epoch
            if total_steps > cfg.lr_decay_steps:
                self._print(
                    f"fit: WARNING — {total_steps} total steps exceed the LR decay horizon "
                    f"lr_decay_steps={cfg.lr_decay_steps}; steps past it run at the "
                    f"lr_min_frac={cfg.lr_min_frac} floor. Set cfg.lr_decay_steps (or "
                    "cfg.epochs) to the real budget before constructing the Learner."
                )
        n_remaining = epochs - self.epoch
        if n_remaining <= 0:
            self._print(f"fit: epoch budget {epochs} already reached (resumed at epoch "
                        f"{self.epoch}) — nothing to train")
            return
        if self.epoch:
            self._print(f"fit: resuming at epoch {self.epoch}/{epochs} ({n_remaining} remaining)")

        smooth = SmoothenValue()
        skip = min(self._resume_batches, n_batches_epoch)
        self._resume_batches = 0
        if skip:
            self._print(f"fit: resuming epoch {self.epoch} mid-way at batch {skip}/{n_batches_epoch}")
        for _ in range(n_remaining):
            self.data.train_dl.set_epoch(self.epoch)
            self.data.train_dl.start_batch = skip
            epoch_skip, skip = skip, 0
            t0 = time.time()
            n_batches = epoch_skip
            last_ls: dict[str, float] = {}
            pending: _LateLosses | None = None
            stop = False
            for batch in self.data.train_dl:
                self.state, ls = self.train_step(self.state, batch)
                n_batches += 1
                if (cfg.ckpt_every_steps > 0 and n_batches % cfg.ckpt_every_steps == 0
                        and n_batches < n_batches_epoch):
                    self._epoch_batches = n_batches
                    self.save_model_dict(best=False)
                if n_batches % cfg.log_every == 0:
                    if pending is not None:
                        last_ls = pending.read()
                        smooth.add_value(last_ls["total"])
                    pending = _LateLosses(ls)
                stop = self._stop_agreed()
                if stop:
                    break
            if pending is not None:
                last_ls = pending.read()
                smooth.add_value(last_ls["total"])
            if stop:
                self._stop_requested = False
                self._epoch_batches = n_batches
                self.save_model_dict(best=False)
                self._print(f"fit: stop requested — checkpointed at epoch {self.epoch} batch "
                            f"{n_batches}/{n_batches_epoch} (resumable)")
                return
            train_time = time.time() - t0
            metrics = self.validate()
            self._log_row({
                "epoch": self.epoch,
                "step": self.state.step,
                "train_loss_smooth": smooth.smooth,
                **{f"train_{k}": v for k, v in last_ls.items()},
                **{f"val_{k}": v for k, v in metrics.items()},
                "train_time_s": round(train_time, 2),
                "qps": round((n_batches - epoch_skip) * cfg.bs * cfg.queries_per_img
                             / max(train_time, 1e-9), 2),
                "lr": self._effective_lr(),
            })
            # epoch counts completed epochs; it moves before the save so a
            # resume continues with the next epoch.
            self.epoch += 1
            self._epoch_batches = 0
            acc = metrics.get("Acc", 0.0)
            if acc >= self.best_metric:
                self.best_metric = acc
                self.save_model_dict(best=True)
            elif self.epoch % cfg.ckpt_every_epochs == 0:
                self.save_model_dict(best=False)
            if cfg.use_reduce_lr_plateau:
                new_scale = self.plateau.step(acc)
                if new_scale != self.state.lr_scale:
                    self.state.lr_scale = new_scale
                    self._print(f"plateau: lr_scale → {new_scale:g}")

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _eval_weights(self) -> Iterator[None]:
        """The EMA parameters in the model for the duration (when
        ``cfg.ema_decay > 0``), with the live BatchNorm statistics."""
        if self.state.ema is None:
            yield
            return
        params = dict(self.model.named_parameters())
        backup = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(self.state.ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(backup[n])

    def _run_eval(self, dl, dump: str | None = None) -> dict[str, float]:
        evaluator = Evaluator(self.cfg.acc_iou_threshold)
        with self._eval_weights():
            for batch in dl:
                ev = self.eval_step(self.model, batch)
                cases, ids, valid = batch.get("case"), batch.get("idxs"), batch.get("valid")
                if "pair_valid" in batch:  # grouped: per-pair metrics, pair-major
                    valid = (np.asarray(valid, dtype=bool)[:, None] & batch["pair_valid"]).reshape(-1)
                    cases = None if cases is None else np.asarray(cases).reshape(-1)
                    ids = None if ids is None else np.asarray(ids).reshape(-1)
                if self._spatial is not None:  # the rows of this member's metrics
                    n_img = len(batch["img"])
                    cases, ids, valid = (None if a is None else self._spatial.counted(np.asarray(a).reshape(-1), n_img)
                                         for a in (cases, ids, valid))
                if self.mesh is not None and self.mesh.world_size > 1:
                    ev, cases, ids, valid = self._gathered(ev, cases, ids, valid)
                evaluator.update(ev, cases=cases, ids=ids, valid=valid)
        summary = evaluator.summarize()
        if dump and self.is_main:
            evaluator.dump_predictions(str(self.pred_dir / f"{self.uid}_{dump}.jsonl"))
        return summary

    def _gathered(self, ev: dict[str, Tensor], cases, ids, valid) -> tuple:
        """Every rank's per-sample metrics and host metadata of one global
        batch, concatenated in rank order (= the global batch's order), as
        at JAX ``learner.py:466-503``. The metrics go to the host first and
        travel through the host group, so one route serves NCCL and gloo.
        ``loss`` is already the global batch's on every rank."""
        local = ({k: v.cpu().numpy() for k, v in ev.items()},
                 None if cases is None else np.asarray(cases).reshape(-1),
                 None if ids is None else np.asarray(ids).reshape(-1),
                 None if valid is None else np.asarray(valid, dtype=bool).reshape(-1))
        parts = mesh_lib.all_gather_host(local, self.mesh)
        cat = lambda xs: None if xs[0] is None else np.concatenate(xs)  # noqa: E731
        ev_all = {k: np.concatenate([p[0][k] for p in parts]) for k in local[0]}
        return ev_all, cat([p[1] for p in parts]), cat([p[2] for p in parts]), cat([p[3] for p in parts])

    def validate(self) -> dict[str, float]:
        return self._run_eval(self.data.valid_dl, dump="val")

    def testing(self) -> dict[str, float]:
        if self.data.test_dl is None:
            raise ValueError("no test split for this dataset")
        return self._run_eval(self.data.test_dl, dump="test")

    def overfit_batch(self, steps: int = 100) -> tuple[float, float]:
        """Train ``steps`` times on the first training batch; → (first loss,
        last loss)."""
        batch = self.data.train_dl.first_batch()
        first = last = float("inf")
        for i in range(steps):
            self.state, ls = self.train_step(self.state, batch)
            last = float(ls["total"])
            if i == 0:
                first = last
        return first, last

    # ------------------------------------------------------------------
    def _payload(self) -> dict[str, Any]:
        """Tensors (on the CPU) and plain Python values only."""
        cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
        payload = {
            "model": cpu(self.model.state_dict()),
            "optimizer": self.state.optimizer.state_dict(),
            "step": self.state.step,
            "epoch": self.epoch,
            # Batches of epoch `epoch` already trained: 0 at epoch ends, N
            # for a save inside the epoch.
            "epoch_batches": self._epoch_batches,
            "best_metric": float(self.best_metric),
            "lr_scale": float(self.state.lr_scale),
            "plateau_best": float(self.plateau.best),
            "plateau_num_bad": int(self.plateau.num_bad),
        }
        if self.state.ema is not None:
            payload["ema"] = cpu(self.state.ema)
        return payload

    def save_model_dict(self, best: bool = False) -> None:
        """Checkpoint the current state (and, with ``best``, into the best
        store too). Under a data mesh rank 0 writes (the state is equal on
        every rank) while the others wait at a barrier, so no rank goes on
        to read a checkpoint that is still being written."""
        if self.is_main:
            self._write_sidecars()
            payload = self._payload()
            self.ckpt.save(self.state.step, payload)
            if best:
                self.ckpt_best.save(self.state.step, payload)
                (self.model_dir / "best_step.txt").write_text(str(self.state.step))
        if self.mesh is not None and self.mesh.world_size > 1:
            mesh_lib.barrier(self.mesh)

    def _write_sidecars(self) -> None:
        """``cfg.json`` and ``vocab.json`` beside the checkpoints, so the
        directory alone rebuilds the model."""
        if self._sidecars_written:
            return
        (self.model_dir / "cfg.json").write_text(
            self.cfg.replace(vocab_size=len(self.data.vocab)).dumps())
        self.data.vocab.save(self.model_dir / "vocab.json")
        self._sidecars_written = True

    def load_model_dict(
        self, path: str | None = None, strict: bool = True, prefer_best: bool = False,
        step: int | None = None,
    ) -> None:
        """Restore the latest step, the best one (``prefer_best``) or
        ``step``. ``strict=False`` warm-starts: tensors whose name and shape
        match are loaded, the rest and the optimizer stay fresh."""
        root = self.model_dir if path is None else Path(path)
        mngr = self.ckpt if path is None else CheckpointManager(root)
        if prefer_best:
            best = self.ckpt_best if path is None else CheckpointManager(root / "best")
            if best.latest_step() is not None:
                mngr = best
        restored = mngr.restore(step=step)
        fold_lstm_bias_(restored["model"])  # checkpoints written before init folded bias_hh
        if strict:
            self.model.load_state_dict(restored["model"])
            if "optimizer" in restored:
                self.state.optimizer.load_state_dict(restored["optimizer"])
        else:
            self.model.load_state_dict(partial_load(self.model.state_dict(), restored["model"]))
        self.state.step = int(restored.get("step", 0))
        self.state.lr_scale = float(restored.get("lr_scale", 1.0))
        self.plateau.scale = self.state.lr_scale
        self.plateau.best = float(restored.get("plateau_best", float("-inf")))
        self.plateau.num_bad = int(restored.get("plateau_num_bad", 0))
        if self.state.ema is not None:
            # Continue the saved EMA, or start it from the loaded weights.
            ema = restored.get("ema") if strict else None
            params = dict(self.model.named_parameters())
            with torch.no_grad():
                for n, e in self.state.ema.items():
                    e.copy_(ema[n] if ema is not None else params[n])
        self.epoch = int(restored.get("epoch", 0))
        self._resume_batches = int(restored.get("epoch_batches", 0))
        self.best_metric = float(restored.get("best_metric", -1.0))

    # ------------------------------------------------------------------
    def _effective_lr(self) -> float:
        """The learning rate of the next update."""
        cfg = self.cfg
        lr = cfg.lr * self.state.lr_scale
        if cfg.lr_schedule != "const" or cfg.warmup_steps > 0:
            lr *= lr_schedule_scale(cfg, self.state.step)
        return lr

    def _log_row(self, row: dict[str, Any]) -> None:
        """The epoch's row into the JSONL log (and TensorBoard), on rank 0."""
        if not self.is_main:
            return
        with open(self.log_file, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            step = int(row.get("step", row.get("epoch", 0)))
            # A writer per row, closed at once: a writer's flush() leaves the
            # events still queued in its thread unwritten.
            with self._tb(str(self.log_dir / "tb" / self.uid), filename_suffix=f".{time.time_ns()}") as tb:
                for k, v in row.items():
                    if isinstance(v, (int, float)) and k != "step":
                        tb.add_scalar(k, float(v), step)
        keys = ("epoch", "train_loss_smooth", "val_Acc", "val_MaxPos", "qps")
        print("  ".join(
            f"{k}={row[k]:.4g}" if isinstance(row.get(k), float) else f"{k}={row.get(k)}"
            for k in keys
        ))
