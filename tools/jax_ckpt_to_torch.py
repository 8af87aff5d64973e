"""A JAX package checkpoint (Orbax) → a checkpoint of the PyTorch port.

    python tools/jax_ckpt_to_torch.py <jax_ckpt_dir> <out_dir> [--step=N]

Reads the latest step (or ``--step``) of a ``zsgnet_tpu`` run directory or
its ``best/`` store with ``zsgnet_tpu.train.checkpoint.CheckpointManager``,
maps the variables onto the port's names with
``zsgnet_tpu_torch.convert.state_dict_from_jax`` and writes
``<out_dir>/step_<N>.pt`` with ``model`` — and ``ema`` when the run kept
``ema_params`` — plus ``step``, ``epoch`` and ``best_metric``, and copies the
``cfg.json`` and ``vocab.json`` found beside the input. The result serves
with ``zsgnet_tpu_torch.predict.Grounder.from_checkpoint(out_dir)`` and
resumes with ``python -m zsgnet_tpu_torch.main <uid> --resume=True
--resume_path=<out_dir>``. It imports jax, so it lives outside the port.
"""

import pathlib
import shutil
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def convert(jax_dir, out_dir, step=None) -> pathlib.Path:
    """→ the written ``step_<N>.pt``."""
    import jax

    from zsgnet_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.convert import state_dict_from_jax
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet
    from zsgnet_tpu_torch.train.checkpoint import CheckpointManager, find_sidecar, load_sidecar_cfg

    jax_dir, out_dir = pathlib.Path(jax_dir), pathlib.Path(out_dir)
    mngr = JaxCheckpointManager(jax_dir)
    step = mngr.latest_step() if step is None else int(step)
    restored = jax.tree.map(np.asarray, mngr.restore(step))
    cfg = load_sidecar_cfg(jax_dir) or get_default_cfg()
    stats = restored.get("batch_stats") or {}
    model = state_dict_from_jax({"params": restored["params"], "batch_stats": stats}, cfg)
    payload = {
        "model": model,
        "step": int(restored.get("step", step)),
        "epoch": int(restored.get("epoch", 0)),
        "best_metric": float(restored.get("best_metric", -1.0)),
    }
    if restored.get("ema_params"):
        ema = state_dict_from_jax({"params": restored["ema_params"], "batch_stats": stats}, cfg)
        vocab_size = model["embedding.weight"].shape[0]
        names = [n for n, _ in ZSGNet(cfg, vocab_size).named_parameters()]
        payload["ema"] = {n: ema[n] for n in names}
    CheckpointManager(out_dir).save(step, payload)
    for name in ("cfg.json", "vocab.json"):
        src = find_sidecar(jax_dir, name)
        if src is not None:
            shutil.copy(src, out_dir / name)
    return out_dir / f"step_{step}.pt"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if not a.startswith("--")]
    flags = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if len(pos) != 2:
        raise SystemExit(__doc__)
    print(f"wrote {convert(pos[0], pos[1], flags.get('step'))}")


if __name__ == "__main__":
    main()
