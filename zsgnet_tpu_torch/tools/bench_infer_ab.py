"""Inference A/B on the card: the per-level head against the canvas head
and int8, on one set of parameters.

    python -m zsgnet_tpu_torch.tools.bench_infer_ab [B]

Counterpart of ``tools/bench_infer_ab.py``, on the headline protocol of
``zsgnet_tpu_torch.bench`` (its batch draw, forward plus top-anchor decode,
3 calls, a synchronize, 100 timed calls closed by a value fetch) at batch B
(default 128): "per-level" is the model's own forward, "canvas" the same
parameters through the shared head's canvas (``forward(canvas=True)``),
"int8" the same parameters calibrated at ``calib@0.999`` on the batch.
Prints the card's name and power limit, then ms per call, pairs/s and the
boxes' checksum of each; ``bench`` returns them.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from zsgnet_tpu_torch.bench import ITERS, VOCAB, WARMUP, calibrate, card_line, flat_batch, infer, measure
from zsgnet_tpu_torch.config import Config, get_default_cfg
from zsgnet_tpu_torch.models.quant import set_quant_mode
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
from zsgnet_tpu_torch.parallel.train_step import to_device
from zsgnet_tpu_torch.utils.backend import resolve_device

VARIANTS = (("per-level", "off", None), ("canvas", "off", True), ("int8", "int8", None))


def bench(b: int = 128, device: str | torch.device = "cuda", cfg: Config | None = None, warmup: int = WARMUP,
          iters: int = ITERS) -> dict:
    """{"per-level" | "canvas" | "int8": {"ms", "qps", "checksum"}}."""
    dev = resolve_device(device)
    cfg = (cfg or get_default_cfg()).replace(bs=b, do_dist=False, quant_mode="int8")
    batch = to_device(flat_batch(np.random.default_rng(0), cfg, b), dev)
    model = get_default_net(cfg, VOCAB, device=dev)
    anchors = torch.as_tensor(anchor_pyramid_for(cfg), device=dev)
    print(f"B={b} device={dev}", flush=True)
    res = {}
    for name, mode, canvas in VARIANTS:
        if mode == "int8":
            calibrate(model, batch)
        set_quant_mode(model, mode)
        qps, out = measure(lambda: infer(model, anchors, batch["img"], batch["qvec"], batch["qlens"], canvas=canvas),
                           b, warmup, iters, dev)
        res[name] = {"ms": b / qps * 1e3, "qps": qps, "checksum": float(out[0].sum())}
        print(f"{name:10s} {res[name]['ms']:7.2f} ms  {qps:8.1f} qps  (checksum {res[name]['checksum']:.4f})",
              flush=True)
    return res


def main(argv: list[str]) -> int:
    b = int(argv[0]) if argv else 128
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    bench(b, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
