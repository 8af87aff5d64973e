"""Inference cost broken down: the forward alone, with the top-anchor
decode, and with the whole evaluation (IoU, accuracy, the MaxPos oracle).

    python -m zsgnet_tpu_torch.tools.profile_bench [B]

Counterpart of ``tools/profile_bench.py``: the default retina model at 300²
(bf16 convolutions on the card), seeded random weights, batch B (default
64) of float images already normalized (N(0, 1), as there), vocab 10000,
query lengths 3–11 and a fixed gt box; each function timed over 20 calls
after 3 (``utils.profiling.time_fn``, closed by a synchronize). Prints the
card's name and power limit, then ms per call and pairs/s of each;
``bench`` returns them.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from zsgnet_tpu_torch.bench import VOCAB, card_line
from zsgnet_tpu_torch.config import Config, get_default_cfg
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
from zsgnet_tpu_torch.train.evaluator import decode_best_box, eval_batch
from zsgnet_tpu_torch.utils.backend import resolve_device
from zsgnet_tpu_torch.utils.profiling import time_fn

B = 64


def bench(b: int = B, device: str | torch.device = "cuda", cfg: Config | None = None, warmup: int = 3,
          iters: int = 20) -> dict:
    """{"fwd_only" | "fwd_decode" | "fwd_full_eval": {"ms", "qps"}}."""
    dev = resolve_device(device)
    cfg = (cfg or get_default_cfg()).replace(bs=b, do_dist=False)
    model = get_default_net(cfg, VOCAB, device=dev)
    rng = np.random.default_rng(0)
    h, w = cfg.resize_img
    img = torch.from_numpy(rng.normal(size=(b, h, w, 3)).astype(np.float32)).to(dev)
    qvec = torch.from_numpy(rng.integers(1, VOCAB, size=(b, cfg.max_qlen)).astype(np.int32)).to(dev)
    qlens = torch.from_numpy(rng.integers(3, 12, size=(b,)).astype(np.int32))
    gt = torch.from_numpy(np.tile(np.float32([-0.5, -0.5, 0.5, 0.5]), (b, 1))).to(dev)
    anchors = torch.as_tensor(anchor_pyramid_for(cfg), device=dev)

    @torch.inference_mode()
    def fwd_only():
        return model(img, qvec, qlens)["att_out"]

    @torch.inference_mode()
    def fwd_decode():
        out = model(img, qvec, qlens)
        return decode_best_box(out["att_out"], out["bbx_out"], anchors)

    @torch.inference_mode()
    def fwd_full_eval():
        out = model(img, qvec, qlens)
        return eval_batch(out["att_out"], out["bbx_out"], anchors, gt, 0.5)["pred_box"]

    res = {}
    for name, fn in (("fwd_only", fwd_only), ("fwd_decode", fwd_decode), ("fwd_full_eval", fwd_full_eval)):
        t, _ = time_fn(fn, warmup=warmup, iters=iters)
        res[name] = {"ms": t * 1e3, "qps": b / t}
        print(f"{name:14s} {t * 1000:8.2f} ms/iter  {b / t:9.1f} qps", flush=True)
    return res


def main(argv: list[str]) -> int:
    b = int(argv[0]) if argv else B
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    bench(b, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
