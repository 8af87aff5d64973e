"""Checkpoints — port of ``zsgnet_tpu/train/checkpoint.py`` on ``torch.save``.

A checkpoint is one file, ``step_<N>.pt``, holding a dict of tensors and
plain Python values only, so that ``torch.load(weights_only=True)`` reads
it back. Saves are synchronous and atomic: the file is written under a
temporary name and moved into place with ``os.replace``, so a crash never
leaves a partial checkpoint. The manager keeps the newest
``max_to_keep`` steps.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, ckpt_dir: str | Path, max_to_keep: int = 3):
        self.dir = Path(ckpt_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.dir / f"step_{step}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.dir.iterdir() if (m := _NAME.match(p.name)))

    def save(self, step: int, payload: dict[str, Any]) -> None:
        path = self._path(step)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX manager's interface."""

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict[str, Any]:
        """The payload of ``step`` (default: the latest), tensors on the CPU."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def top_level_keys(self, step: int | None = None) -> list[str] | None:
        """The payload's top-level keys, or None when there is no checkpoint."""
        if (step if step is not None else self.latest_step()) is None:
            return None
        return list(self.restore(step))


def find_sidecar(ckpt_dir: str | Path, name: str) -> Path | None:
    """``cfg.json`` / ``vocab.json`` beside a checkpoint directory; the path
    may be the model directory or its ``best/`` store, so the parent is
    checked too."""
    ckpt_dir = Path(ckpt_dir)
    for d in (ckpt_dir, ckpt_dir.parent):
        if (d / name).exists():
            return d / name
    return None


def load_sidecar_cfg(ckpt_dir: str | Path):
    """The ``Config`` saved beside a checkpoint, or None."""
    from zsgnet_tpu_torch.config import Config

    p = find_sidecar(ckpt_dir, "cfg.json")
    if p is None:
        return None
    return Config().replace(**json.loads(p.read_text()))


def partial_load(fresh: dict[str, torch.Tensor], loaded: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Warm-start merge over ``state_dict``s: the loaded tensor where the
    name and the shape match, the fresh one elsewhere."""
    return {
        k: loaded[k] if k in loaded and tuple(loaded[k].shape) == tuple(v.shape) else v
        for k, v in fresh.items()
    }
