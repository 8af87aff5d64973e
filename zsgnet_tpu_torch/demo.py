"""One-command end-to-end walkthrough — ``python -m zsgnet_tpu_torch.demo``.
Port of ``zsgnet_tpu/demo.py``.

On a tiny synthetic dataset it generates itself (colored shapes and
templated queries, no downloads): train → validate → test → serve from the
bare checkpoint directory → export a ``torch.export`` artifact → serve from
the artifact, whose boxes must stay within 2e-2 of the live ones. Every
stage prints what it did and where its outputs are. It runs on the card
(``--device=cuda``, the default; it raises without one) or, when asked, on
the CPU with the kernels' plain versions.

    python -m zsgnet_tpu_torch.demo [--device=cpu] [--workdir=tmp/demo] [--epochs=2]
        [--n_train=32] [--img_size=64] [--bs=8] [--no_export]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path


def demo(
    workdir: str | Path = "tmp/demo",
    epochs: int = 2,
    n_train: int = 32,
    img_size: int = 64,
    bs: int = 8,
    export: bool = True,
    device: str = "cuda",
) -> dict:
    """Run the walkthrough; returns the final validation metrics, with
    ``box_drift`` (artifact against live) when ``export``."""
    import numpy as np
    import torch

    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.data import synthetic
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.predict import Grounder
    from zsgnet_tpu_torch.train.learner import Learner
    from zsgnet_tpu_torch.utils.backend import resolve_device

    t0 = time.time()
    dev = resolve_device(device)
    workdir = Path(workdir)

    def stage(msg: str) -> None:
        print(f"[{time.time() - t0:6.1f}s] {msg}", flush=True)

    stage(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    root = workdir / "data"
    if not (root / "synthetic").exists():
        synthetic.generate(root, n_train=n_train, n_val=max(n_train // 4, 4),
                           n_test=max(n_train // 4, 4), img_size=img_size)
    stage(f"synthetic dataset ready under {root}/synthetic ({n_train} train images of colored "
          "shapes + queries)")

    cfg = Config(
        ds_to_use="synthetic", data_dir=str(root), bs=bs, nw=2, lr=2e-3,
        resize_img=(img_size, img_size), max_qlen=8, lstm_dim=16, emb_dim=16,
        fpn_ch=32, head_ch=32, epochs=epochs, log_every=1, tmp_path=str(workdir / "tmp"),
        # float32: stable on any device; bench tools and chip_smoke.py run bf16.
        compute_dtype="float32", use_pallas=False, do_dist=False,
    )
    data = get_data(cfg)
    learn = Learner("demo", data, cfg, device=dev)
    stage(f"training {epochs} epochs (B={bs}, {img_size}² retina ZSGNet, "
          f"{len(data.train_dl)} steps/epoch)")
    learn.fit(epochs)
    metrics = learn.validate()
    stage(f"validate: Acc={metrics['Acc']:.3f} MaxPos={metrics['MaxPos']:.3f} "
          f"MeanIoU={metrics['MeanIoU']:.3f}")
    test_metrics = learn.testing()
    stage(f"test: Acc={test_metrics['Acc']:.3f} ({int(test_metrics['num_samples'])} samples)")
    stage(f"checkpoint dir (self-contained: weights + cfg.json + vocab.json): {learn.model_dir}")

    # Serve from the bare directory: no cfg, no vocab, only the path.
    g = Grounder.from_checkpoint(learn.model_dir, batch_size=4, device=dev)
    img_path, query = _sample_pair(root)
    res = g.ground([img_path], [query])[0]
    stage(f"Grounder.from_checkpoint: {query!r} → box={np.round(res['box_xyxy'], 1)} "
          f"score={res['score']:.3f}")

    if export:
        from zsgnet_tpu_torch.export import ExportedGrounder, export_serving

        # One program, at the Grounder's batch size.
        art = export_serving(g, workdir / "artifact", platforms=(dev.type,))
        served = ExportedGrounder.load(art, device=dev)
        res2 = served.ground([img_path], [query])[0]
        drift = float(np.abs(np.asarray(res2["box_norm"]) - np.asarray(res["box_norm"])).max())
        stage(f"torch.export artifact at {art} serves without the model code: box drift vs "
              f"live = {drift:.2e}")
        if not drift < 2e-2:
            raise AssertionError(f"exported artifact diverged from live serving: drift {drift}")
        metrics = {**metrics, "box_drift": drift}

    stage("demo complete — next: README.md (training, serving, the port's commands)")
    return metrics


def _sample_pair(root: Path) -> tuple[Path, str]:
    """The first validation (image, query) pair of the synthetic CSVs."""
    import csv

    with open(root / "synthetic" / "csv_dir" / "val.csv") as f:
        row = next(csv.DictReader(f))
    return root / "synthetic" / "images" / row["img_id"], row["query"]


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default="tmp/demo")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--n_train", type=int, default=32)
    p.add_argument("--img_size", type=int, default=64)
    p.add_argument("--bs", type=int, default=8)
    p.add_argument("--no_export", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    demo(a.workdir, a.epochs, a.n_train, a.img_size, a.bs, export=not a.no_export, device=a.device)


if __name__ == "__main__":
    main(sys.argv[1:])
