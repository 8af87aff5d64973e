"""Inspect a checkpoint directory or an exported artifact —
``python -m zsgnet_tpu_torch.ckpt_info <dir>``. Port of
``zsgnet_tpu/ckpt_info.py``.

Answers what a stranger asks before resuming, serving or migrating a run:
what architecture this is (the config keys off their defaults), how far it
trained (epoch, step, best), how big it is (parameters, BatchNorm
statistics, optimizer state, EMA), and whether the directory restores on
its own. It reads:

* the Learner's checkpoint directories (``step_<N>.pt`` files with
  ``cfg.json`` and ``vocab.json`` beside them), the run's directory or its
  ``best/`` store;
* the serving artifacts of ``zsgnet_tpu_torch.export`` (``export.json``
  with ``"format": "torch.export"``, one program set per platform).

The JAX package's Orbax directories (digit-named step directories) and its
StableHLO artifacts (``export.json`` without ``format``) are named as such;
``tools/jax_ckpt_to_torch.py`` converts a JAX checkpoint into the port's.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.export import FORMAT
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager, find_sidecar, load_sidecar_cfg

_CONVERT = "convert it with tools/jax_ckpt_to_torch.py (needs jax), then inspect or export the result"
_BN_STATS = ("running_mean", "running_var")


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024:
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TiB"


def _cfg_diff(cfg_dict: dict) -> dict:
    """The config keys whose values differ from the port's defaults."""
    defaults = {f.name: f.default for f in dataclasses.fields(Config)}
    diff = {}
    for k, v in cfg_dict.items():
        vv = tuple(v) if isinstance(v, list) else v
        if vv != defaults.get(k, "<unknown>"):
            diff[k] = vv
    return diff


def _tensor_stats(tensors) -> tuple[int, int]:
    """(elements, bytes) of the tensors in a nested dict or list."""
    n_elem = n_bytes = 0
    stack = [tensors]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            n_elem += x.numel()
            n_bytes += x.numel() * x.element_size()
    return n_elem, n_bytes


def _size(elements: int, n_bytes: int) -> str:
    return f"{elements / 1e6:.2f} M ({_human(n_bytes)})"


def describe_artifact(d: Path) -> dict:
    meta = json.loads((d / "export.json").read_text())
    if meta.get("format") != FORMAT:
        raise SystemExit(f"{d}: a JAX package serving artifact (StableHLO export.json without "
                         f"'format'), which this package does not serve; export from a checkpoint "
                         f"instead: {_CONVERT}")
    programs = sorted(d.glob("*/serving_*.pt2"))
    info = {
        "kind": "serving artifact (torch.export programs, zsgnet_tpu_torch.export)",
        "version": meta.get("version"),
        "platforms": meta.get("platforms"),
        "buckets": meta.get("bucket_sizes") or [meta.get("batch_size")],
        "quantized": bool(meta.get("quantized")),
        "vocab_size": meta.get("cfg", {}).get("vocab_size"),
        "programs": {str(p.relative_to(d)): _human(p.stat().st_size) for p in programs},
        "cfg_non_default": _cfg_diff(meta.get("cfg", {})),
    }
    if (d / "weights.npz").exists():
        info["weights.npz"] = _human((d / "weights.npz").stat().st_size)
    return info


def _split_state_dict(sd: dict) -> tuple[dict, dict, dict]:
    """(parameters, BatchNorm running statistics, other buffers) of a
    ``state_dict`` by name: BatchNorm's ``num_batches_tracked`` is the only
    other buffer the model keeps."""
    stats = {k: v for k, v in sd.items() if k.rsplit(".", 1)[-1] in _BN_STATS}
    other = {k: v for k, v in sd.items() if k.endswith("num_batches_tracked")}
    params = {k: v for k, v in sd.items() if k not in stats and k not in other}
    return params, stats, other


def describe_checkpoint(d: Path) -> dict:
    mgr = CheckpointManager(d)
    latest = mgr.latest_step()
    if latest is None:
        if any(p.is_dir() and p.name.isdigit() for p in d.iterdir()):
            raise SystemExit(f"{d}: a JAX package checkpoint (Orbax step directories); {_CONVERT}")
        raise SystemExit(f"{d}: no step_<N>.pt checkpoints (and no export.json)")
    restored = mgr.restore(latest)
    params, stats, other = _split_state_dict(restored["model"])
    counts = {"params": _tensor_stats(params), "batch_stats": _tensor_stats(stats),
              "other_buffers": _tensor_stats(other),
              "opt_state": _tensor_stats(restored.get("optimizer", {}).get("state", {}))}
    info = {
        "kind": "Learner checkpoint dir (zsgnet_tpu_torch: step_<N>.pt + cfg/vocab sidecars)",
        "steps_on_disk": mgr.all_steps(),
        "latest_step": latest,
        "epoch": restored.get("epoch"),
        # > 0: saved inside the epoch (cfg.ckpt_every_steps or a stop
        # request); a resume goes on at this batch of `epoch`.
        "epoch_batches": restored.get("epoch_batches"),
        "best_metric": restored.get("best_metric"),
        "lr_scale": restored.get("lr_scale"),
        "plateau": {"best": restored.get("plateau_best"), "num_bad": restored.get("plateau_num_bad")},
        "params": _size(*counts["params"]),
        "batch_stats": _size(*counts["batch_stats"]) + " — BatchNorm running mean and var",
        "other_buffers": _size(*counts["other_buffers"]) + " — BatchNorm step counters",
        "opt_state": _size(*counts["opt_state"]),
    }
    if restored.get("ema"):
        counts["ema_params"] = _tensor_stats(restored["ema"])
        # cfg.ema_decay > 0: the Grounder and export serve these weights.
        info["ema_params"] = _size(*counts["ema_params"]) + " — served"
    info["restorable_total"] = _human(sum(b for _, b in counts.values()))
    info["elements"] = {k: n for k, (n, _) in counts.items()}
    for marker in (d / "best_step.txt", d.parent / "best_step.txt"):
        if marker.exists():
            info["best_step"] = int(marker.read_text().strip())
            break
    cfg = load_sidecar_cfg(d)
    if cfg is not None:
        info["cfg_non_default"] = _cfg_diff(cfg.to_dict())
        info["self_contained"] = find_sidecar(d, "vocab.json") is not None
    else:
        info["self_contained"] = False
        info["warning"] = "no cfg.json beside it: a resume needs the original flags"
    return info


def describe(path: str | Path) -> dict:
    d = Path(path)
    if not d.is_dir():
        raise SystemExit(f"{d}: no such directory")
    if (d / "export.json").exists():
        return describe_artifact(d)
    return describe_checkpoint(d)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        raise SystemExit(__doc__)
    print(json.dumps(describe(argv[0]), indent=2, default=str))


if __name__ == "__main__":
    main()
