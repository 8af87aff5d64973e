"""Grouped multi-query training against the flat train step, in pairs/s.

    python -m zsgnet_tpu_torch.tools.bench_grouped_train [PAIRS] [Q]

Counterpart of ``tools/bench_grouped_train.py``: the train step
(``parallel.train_step.make_train_step``, the default retina model at 300²,
bf16 convolutions, Adam, K1 and K2 on the card) at equal (image, phrase)
pairs per step (default 60):

* flat — ``bs = PAIRS``, one backbone pass per pair;
* grouped — PAIRS / Q images × Q phrases (``cfg.queries_per_img``, default
  Q = 5), one backbone pass per image;
* grouped with ``pair_valid[0, -1] = False``: one wrapped pair a batch,
  weighted 0 in the loss.

The step takes host batches; each is kept in pinned memory, so a step pays
its upload but not a copy into pinned memory. The port's grouped step always
weights its pairs by ``pair_valid``, all ones in the unmasked run. Batches
come from one ``np.random.default_rng(0)`` in the JAX tool's order (gt, then
images, queries, lengths, per run); each run builds its model from seed 0.
3 warm-up steps and a value fetch, then 30 timed steps closed by one.
Prints the card's name and power limit, ms per step and pairs/s of each
run, and the two speedups; ``bench`` returns them.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from zsgnet_tpu_torch.bench import VOCAB, card_line
from zsgnet_tpu_torch.config import Config, get_default_cfg
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step
from zsgnet_tpu_torch.utils.backend import resolve_device

PAIRS, Q = 60, 5
WARMUP, ITERS = 3, 30


def host_batch(batch: dict, device: torch.device) -> dict:
    """numpy arrays as CPU tensors, pinned when the step uploads to a card."""
    return {k: torch.from_numpy(v).pin_memory() if device.type == "cuda" else torch.from_numpy(v)
            for k, v in batch.items()}


def time_steps(step, state, batch: dict, pairs: int, warmup: int, iters: int, tag: str) -> dict:
    """``warmup`` steps and a value fetch, then ``iters`` timed steps
    closed by one → ms per step, pairs/s and the last loss."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        state, ls = step(state, batch)
    float(ls["total"])
    print(f"{tag}: warm-up {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, ls = step(state, batch)
    total = float(ls["total"])  # the fetch waits for every queued step
    dt = time.perf_counter() - t0
    res = {"ms": dt / iters * 1e3, "pairs_per_s": pairs * iters / dt, "loss": total}
    print(f"{tag}: {res['ms']:.1f} ms/step, {res['pairs_per_s']:.1f} pairs/s (loss {total:.3f})", flush=True)
    return res


def bench(pairs: int = PAIRS, q: int = Q, device: str | torch.device = "cuda", cfg: Config | None = None,
          warmup: int = WARMUP, iters: int = ITERS) -> dict:
    """{"flat" | "grouped" | "grouped_masked": {"ms", "pairs_per_s", "loss"},
    "speedup", "speedup_masked"}."""
    dev = resolve_device(device)
    if pairs % q:
        raise ValueError(f"PAIRS={pairs} must be a multiple of Q={q}")
    b_img = pairs // q
    rng = np.random.default_rng(0)
    base = (cfg or get_default_cfg()).replace(do_dist=False)

    def make_batch(grouped: bool) -> tuple[Config, dict]:
        cfg = base.replace(bs=b_img if grouped else pairs, queries_per_img=q if grouped else 1)
        h, w = cfg.resize_img
        n_img = b_img if grouped else pairs
        qshape = (b_img, q) if grouped else (pairs,)
        gt = np.stack([rng.uniform(-1, -0.1, qshape), rng.uniform(-1, -0.1, qshape),
                       rng.uniform(0.1, 1, qshape), rng.uniform(0.1, 1, qshape)], axis=-1).astype(np.float32)
        batch = {
            "img": rng.integers(0, 255, size=(n_img, h, w, 3)).astype(np.uint8),
            "qvec": rng.integers(1, VOCAB, size=qshape + (cfg.max_qlen,)).astype(np.int32),
            "qlens": rng.integers(3, 12, size=qshape).astype(np.int32),
            "annot": gt,
        }
        return cfg, batch

    def run(tag: str, grouped: bool, masked: bool = False) -> dict:
        cfg, batch = make_batch(grouped)
        if grouped:
            pv = np.ones((b_img, q), bool)
            if masked:
                pv[0, -1] = False
            batch["pair_valid"] = pv
        model = get_default_net(cfg, VOCAB, device=dev)
        step = make_train_step(cfg, anchor_pyramid_for(cfg), device=dev)
        return time_steps(step, create_train_state(cfg, model), host_batch(batch, dev), pairs, warmup, iters, tag)

    res = {"flat": run(f"flat bs={pairs}", grouped=False),
           "grouped": run(f"grouped {b_img}x{q}", grouped=True),
           "grouped_masked": run(f"grouped+mask {b_img}x{q}", grouped=True, masked=True)}
    res["speedup"] = res["grouped"]["pairs_per_s"] / res["flat"]["pairs_per_s"]
    res["speedup_masked"] = res["grouped_masked"]["pairs_per_s"] / res["flat"]["pairs_per_s"]
    print(f"grouped speedup at Q={q}: {res['speedup']:.2f}x (with pair_valid mask: {res['speedup_masked']:.2f}x)",
          flush=True)
    return res


def main(argv: list[str]) -> int:
    pairs = int(argv[0]) if argv else PAIRS
    q = int(argv[1]) if len(argv) > 1 else Q
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    bench(pairs, q, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
