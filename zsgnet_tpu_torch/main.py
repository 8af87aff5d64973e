"""Command-line entry point — port of ``zsgnet_tpu/main.py``.

    python -m zsgnet_tpu_torch.main <uid> --ds_to_use=synthetic --data_dir=data
    python -m zsgnet_tpu_torch.main <uid> --only_val=True --resume=True
    python -m zsgnet_tpu_torch.main <uid> --device=cpu ...   # plain versions, no GPU

Data parallel on N local GPUs, one process each (``cfg.bs`` stays the
global batch):

    python -m torch.distributed.run --nproc_per_node=N -m zsgnet_tpu_torch.main <uid> --multi_host=True

Every ``--key=value`` flag is a Config override (reference key names and
aliases accepted, ``--list_flags`` prints them); ``--cfg_file=<path>``
replaces ``configs/cfg.json`` as the config base. ``--device`` (default
``cuda``) is where the run goes. ``--multi_host=True`` joins the process
group that ``torch.distributed.run`` describes (NCCL on ``cuda:LOCAL_RANK``,
gloo with ``--device=cpu``), where the JAX package calls
``jax.distributed.initialize``; each rank loads its shard of every global
batch, rank 0 alone prints and writes, and the group is destroyed at exit.

Spatial partitioning over S members per sample (``cfg.mesh_spatial``), D·S
processes, with or without ``--multi_host=True``:

    python -m torch.distributed.run --nproc_per_node=D·S -m zsgnet_tpu_torch.main <uid> --mesh_spatial=S

Ranks d·S … d·S + S − 1 form spatial group d; each loads data index d's
shard of every global batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from zsgnet_tpu_torch.config import KEY_MAPS, Config, get_default_cfg
from zsgnet_tpu_torch.data.dataset import get_data
from zsgnet_tpu_torch.parallel.mesh import data_shard, init_distributed, is_main_process
from zsgnet_tpu_torch.train.checkpoint import load_sidecar_cfg
from zsgnet_tpu_torch.train.learner import Learner
from zsgnet_tpu_torch.utils.backend import resolve_device


def list_flags() -> str:
    """Every ``--key=value`` override: name, default, reference aliases."""
    aliases: dict[str, list[str]] = {}
    for alias, key in KEY_MAPS.items():
        aliases.setdefault(key, []).append(alias)
    lines = ["Config overrides (--key=value; reference aliases in brackets):"]
    for f in dataclasses.fields(Config):
        al = f"  [{', '.join(sorted(aliases[f.name]))}]" if f.name in aliases else ""
        lines.append(f"  --{f.name}={f.default!r}{al}")
    return "\n".join(lines)


def parse_args(argv: list[str]) -> tuple[str, dict[str, str], bool, str]:
    """→ (uid, config overrides, multi_host, device)."""
    if "--list_flags" in argv:
        raise SystemExit(list_flags())
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("uid", help="experiment id (logs/checkpoints key)")
    parser.add_argument("--multi_host", default="False")
    parser.add_argument("--device", default="cuda")
    known, unknown = parser.parse_known_args(argv)
    overrides: dict[str, str] = {}
    for tok in unknown:
        if not tok.startswith("--") or "=" not in tok:
            raise SystemExit(f"flags must be --key=value, got: {tok}")
        k, v = tok[2:].split("=", 1)
        overrides[k] = v
    return known.uid, overrides, known.multi_host.lower() in ("1", "true"), known.device


def main_dist(uid: str, device: str | torch.device = "cuda", **kwargs) -> dict[str, float]:
    """Programmatic entry (reference ``main_dist(uid, **kwargs)``): builds the
    config, the data and a :class:`Learner`, then validates
    (``only_val``), tests (``only_test``) or fits and validates.

    With ``resume=True`` the checkpoint directory's ``cfg.json`` becomes
    the config base and the call's kwargs override it. SIGTERM asks the
    Learner to checkpoint its position and stop. With a process group up
    (``--multi_host``) the loaders hold this rank's shard of each batch
    (its data index's under ``mesh_spatial``) and the Learner trains data
    parallel."""
    device = resolve_device(device)
    cfg_file = kwargs.pop("cfg_file", None)
    cfg = get_default_cfg(cfg_file).replace(uid=uid, **kwargs)
    if cfg.resume:
        ckpt_root = Path(cfg.resume_path) if cfg.resume_path else Path(cfg.tmp_path) / "models" / uid
        saved = load_sidecar_cfg(ckpt_root)
        if saved is not None:
            cfg = saved.replace(uid=uid, **kwargs)
            if is_main_process():
                print(f"resume: config base loaded from {ckpt_root / 'cfg.json'}")
    np.random.seed(cfg.seed)
    shard_id, num_shards = data_shard(cfg)
    learn = Learner(uid, get_data(cfg, shard_id=shard_id, num_shards=num_shards), cfg, device=device)
    if cfg.only_val:
        metrics = learn.validate()
    elif cfg.only_test:
        metrics = learn.testing()
    else:
        try:
            previous = signal.signal(signal.SIGTERM, lambda *_: learn.request_stop())
        except ValueError:  # not the main thread (embedded use): no handler
            previous = None
        try:
            learn.fit(cfg.epochs, cfg.lr)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
        metrics = learn.validate()
    if is_main_process():
        print({k: round(v, 4) for k, v in metrics.items()})
    return metrics


def main() -> None:
    uid, overrides, multi_host, device = parse_args(sys.argv[1:])
    if int(overrides.get("mesh_spatial", 1)) > 1:
        multi_host = True  # one process per spatial member
    if not multi_host:
        main_dist(uid, device=device, **overrides)
        return
    mesh = init_distributed(device)
    if mesh.rank == 0:
        print(f"process group: {mesh.backend}, {mesh.world_size} rank(s), rank 0 on {mesh.device}",
              flush=True)
    try:
        main_dist(uid, device=mesh.device, **overrides)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
