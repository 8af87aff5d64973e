"""Learner — port of ``zsgnet_tpu/train/learner.py`` for one device.

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

The loss is read back from the device every ``cfg.log_every`` steps, one
interval late, so the loop never waits on the device for it. Not ported
yet (they raise): ``remat_backbone``, ``queries_per_img > 1``,
``mesh_spatial > 1``; ``do_dist`` runs on the one device;
``use_tensorboard`` writes nothing.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Iterator

import torch

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data.dataset import DataWrap
from zsgnet_tpu_torch.data.embeddings import load_embedding_table
from zsgnet_tpu_torch.models.bilstm import fold_lstm_bias_
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
from zsgnet_tpu_torch.parallel.train_step import (
    check_supported,
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
    def __init__(self, uid: str, data: DataWrap, cfg: Config, device: str | torch.device = "cuda"):
        check_supported(cfg)
        self.device = resolve_device(device)
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

        self.model = get_default_net(cfg, len(data.vocab), seed=cfg.seed, device=self.device)
        if cfg.glove_path:
            table, found = load_embedding_table(cfg.glove_path, data.vocab, cfg.emb_dim, cfg.seed)
            with torch.no_grad():
                self.model.embedding.weight.copy_(torch.from_numpy(table))
            print(f"glove init: {found}/{len(data.vocab)} vocab words found")
        self.anchors = anchor_pyramid_for(cfg)
        self.state = create_train_state(cfg, self.model)
        self._train_step = None  # built at first use
        self._stop_requested = False
        self._epoch_batches = 0
        self._resume_batches = 0
        self._sidecars_written = False
        self.eval_step = make_eval_step(cfg, self.anchors, self.device)
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
            self._train_step = make_train_step(self.cfg, self.anchors, self.device)
        return self._train_step

    def request_stop(self) -> None:
        """Ask ``fit`` to stop at the next batch boundary: it checkpoints the
        position inside the epoch and returns, and a resumed ``fit`` goes on
        from there. Safe from a signal handler (a bool store)."""
        self._stop_requested = True

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
                print(f"fit: lr → {lr:g} via lr_scale={scale:g} "
                      "(optimizer moments preserved; plateau continues from it)")
        epochs = epochs or cfg.epochs
        n_batches_epoch = len(self.data.train_dl)
        if cfg.lr_schedule != "const" and cfg.lr_decay_steps > 0:
            total_steps = epochs * n_batches_epoch
            if total_steps > cfg.lr_decay_steps:
                print(
                    f"fit: WARNING — {total_steps} total steps exceed the LR decay horizon "
                    f"lr_decay_steps={cfg.lr_decay_steps}; steps past it run at the "
                    f"lr_min_frac={cfg.lr_min_frac} floor. Set cfg.lr_decay_steps (or "
                    "cfg.epochs) to the real budget before constructing the Learner."
                )
        n_remaining = epochs - self.epoch
        if n_remaining <= 0:
            print(f"fit: epoch budget {epochs} already reached (resumed at epoch "
                  f"{self.epoch}) — nothing to train")
            return
        if self.epoch:
            print(f"fit: resuming at epoch {self.epoch}/{epochs} ({n_remaining} remaining)")

        smooth = SmoothenValue()
        skip = min(self._resume_batches, n_batches_epoch)
        self._resume_batches = 0
        if skip:
            print(f"fit: resuming epoch {self.epoch} mid-way at batch {skip}/{n_batches_epoch}")
        for _ in range(n_remaining):
            self.data.train_dl.set_epoch(self.epoch)
            self.data.train_dl.start_batch = skip
            epoch_skip, skip = skip, 0
            t0 = time.time()
            n_batches = epoch_skip
            last_ls: dict[str, float] = {}
            pending: _LateLosses | None = None
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
                if self._stop_requested:
                    break
            if pending is not None:
                last_ls = pending.read()
                smooth.add_value(last_ls["total"])
            if self._stop_requested:
                self._stop_requested = False
                self._epoch_batches = n_batches
                self.save_model_dict(best=False)
                print(f"fit: stop requested — checkpointed at epoch {self.epoch} batch "
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
                "qps": round((n_batches - epoch_skip) * cfg.bs / max(train_time, 1e-9), 2),
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
                    print(f"plateau: lr_scale → {new_scale:g}")

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
                evaluator.update(ev, cases=batch.get("case"), ids=batch.get("idxs"),
                                 valid=batch.get("valid"))
        summary = evaluator.summarize()
        if dump:
            evaluator.dump_predictions(str(self.pred_dir / f"{self.uid}_{dump}.jsonl"))
        return summary

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
        store too)."""
        self._write_sidecars()
        payload = self._payload()
        self.ckpt.save(self.state.step, payload)
        if best:
            self.ckpt_best.save(self.state.step, payload)
            (self.model_dir / "best_step.txt").write_text(str(self.state.step))

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
        with open(self.log_file, "a") as f:
            f.write(json.dumps(row) + "\n")
        keys = ("epoch", "train_loss_smooth", "val_Acc", "val_MaxPos", "qps")
        print("  ".join(
            f"{k}={row[k]:.4g}" if isinstance(row.get(k), float) else f"{k}={row.get(k)}"
            for k in keys
        ))
