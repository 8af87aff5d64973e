"""Headline benchmark: grounding queries/sec/chip on the flagship model —
the port's counterpart of the root ``bench.py``, on the same protocol.

    python -m zsgnet_tpu_torch.bench [--device=cuda]

Steady-state single-shot grounding inference: the full retina model at 300²
(ResNet-50 + FPN, BiLSTM, fusion head) with seeded random weights, then the
top-anchor decode, at batch 128, bf16 convolutions, on one card. Metric:
image-query pairs per second. Four paths on one set of parameters, timed in
the JAX order:

1. ``value``: the model's forward (uint8 images normalized on the device,
   bf16 autocast on CUDA) and ``train.evaluator.decode_best_box``;
2. ``int8_qps``: the same model calibrated on the flat batch at
   ``calib@0.999`` (``models.quant.set_quant_mode``), then served in int8;
3. ``grouped_q5_qps``: 26 images × 5 queries (130 pairs, one backbone pass
   per image) through the forward's grouped path, the modules back in
   "off";
4. ``grouped_q5_int8_qps``: the grouped batch in int8 on the same scales.

Each path makes ``WARMUP`` calls, synchronizes, then times ``ITERS`` calls
closed by a value fetch. ``score`` is the raw max logit, as the JAX
``decode_best_box_levels`` returns it (the ``Grounder`` returns its
sigmoid). The draws from ``np.random.default_rng(seed)`` are the JAX bench's
in its order, byte for byte. The decode takes the first of tied maxima
where the JAX decode averages them; random inputs give no ties.

``vs_baseline`` divides by ``V100_REF_QPS``, the JAX bench's eager-fp32
PyTorch V100 figure, copied here. Unlike the JAX bench, no path's failure is
caught: a failing path fails the run. Earlier lines give the card's name and
power limit and, per path, the wall ms per call, the card's ms and kernel
launches per call (``torch.profiler`` over 3 calls after the timed loop),
the idle share (1 − device / wall) and the peak memory allocated; the last
line is the JSON row, with the JAX bench's ten keys only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from zsgnet_tpu_torch.config import Config, get_default_cfg
from zsgnet_tpu_torch.models.quant import ScaleBuffers, set_quant_mode
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
from zsgnet_tpu_torch.parallel.train_step import to_device
from zsgnet_tpu_torch.train.evaluator import decode_best_box
from zsgnet_tpu_torch.utils.backend import resolve_device
from zsgnet_tpu_torch.utils.profiling import device_kernels

Tensor = torch.Tensor

V100_REF_QPS = 307.0  # the reference, eager fp32 PyTorch on a V100 (BASELINE.md)
BATCH = 128
WARMUP = 3
ITERS = 100
VOCAB = 10000
GROUP_IMAGES, GROUP_Q = 26, 5  # 130 pairs: the grouping nearest the flat B = 128
CALIB = "calib@0.999"
PROFILE_CALLS = 3


def bench_cfg() -> Config:
    """The JAX bench's configuration: the defaults at ``BATCH``."""
    return get_default_cfg().replace(bs=BATCH, do_dist=False)


def flat_batch(rng: np.random.Generator, cfg: Config, batch: int) -> dict:
    """uint8 images (B, H, W, 3), ``qvec`` (B, T), ``qlens`` (B,), drawn in
    this order."""
    h, w = cfg.resize_img
    return {
        "img": rng.integers(0, 255, size=(batch, h, w, 3)).astype(np.uint8),
        "qvec": rng.integers(1, VOCAB, size=(batch, cfg.max_qlen)).astype(np.int32),
        "qlens": rng.integers(3, 12, size=(batch,)).astype(np.int32),
    }


def make_batches(cfg: Config, batch: int, seed: int = 0) -> tuple[dict, dict]:
    """(flat, grouped) numpy batches: the flat draws, then from the same
    generator the grouped ``qvec`` (26, 5, T) and ``qlens`` (26, 5); the
    grouped images are the first 26 flat images."""
    if batch < GROUP_IMAGES:
        raise ValueError(f"batch {batch} holds fewer than the grouped batch's {GROUP_IMAGES} images")
    rng = np.random.default_rng(seed)
    flat = flat_batch(rng, cfg, batch)
    grouped = {
        "img": flat["img"][:GROUP_IMAGES],
        "qvec": rng.integers(1, VOCAB, size=(GROUP_IMAGES, GROUP_Q, cfg.max_qlen)).astype(np.int32),
        "qlens": rng.integers(3, 12, size=(GROUP_IMAGES, GROUP_Q)).astype(np.int32),
    }
    return flat, grouped


@torch.inference_mode()
def infer(model: torch.nn.Module, anchors: Tensor, img: Tensor, qvec: Tensor, qlens: Tensor,
          canvas: bool | None = None) -> tuple[Tensor, Tensor]:
    """→ (pred_box (N, 4) clipped tlbr, score (N,) the raw max logit) for
    N pairs (flat ``qvec`` (N, T), or grouped (B, Q, T) with N = B·Q)."""
    out = model(img, qvec, qlens, canvas=canvas)
    att = out["att_out"]
    return decode_best_box(att, out["bbx_out"], anchors), att.max(dim=-1).values


@torch.no_grad()
def calibrate(model: torch.nn.Module, batch: dict, mode: str = CALIB) -> None:
    """Record every quantized conv's activation scales on ``batch``, then
    leave the model in int8. Under ``no_grad``, not ``inference_mode``, so
    the new scale buffers take a later ``load_state_dict``."""
    set_quant_mode(model, mode)
    model(batch["img"], batch["qvec"], batch["qlens"])
    set_quant_mode(model, "int8")


def quant_modes(model: torch.nn.Module) -> set[str]:
    """The modes of the model's quantizable modules (convs and heads)."""
    return {m.mode for m in model.modules() if isinstance(m, ScaleBuffers)}


def measure(fn: Callable[[], tuple], n_pairs: int, warmup: int = WARMUP, iters: int = ITERS,
            device: torch.device | None = None) -> tuple[float, tuple]:
    """``warmup`` calls and a synchronize, then ``iters`` timed calls closed
    by a value fetch → (pairs per second, the last call's output)."""
    for _ in range(warmup):
        fn()
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    float(out[0].sum())  # the fetch waits for every queued call
    return n_pairs * iters / (time.perf_counter() - t0), out


def time_path(name: str, fn: Callable[[], tuple], n_pairs: int, device: torch.device,
              warmup: int, iters: int) -> dict:
    """One path's pairs/s and wall ms per call; on a card also its device ms
    and launches per call, idle share and peak memory allocated. Prints
    them on one line."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    qps, out = measure(fn, n_pairs, warmup, iters, device)
    stats = {"qps": qps, "wall_ms": n_pairs / qps * 1e3, "device_ms": None, "launches": None,
             "idle": None, "peak_bytes": None}
    if device.type == "cuda":
        kernels = device_kernels(fn, PROFILE_CALLS)
        stats["device_ms"] = sum(t for _, t, _ in kernels)
        stats["launches"] = sum(n for *_, n in kernels)
        stats["idle"] = 1.0 - stats["device_ms"] / stats["wall_ms"]
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        card = (f"device {stats['device_ms']:.3f} ms/call in {stats['launches']:.0f} launches, idle "
                f"{stats['idle']:.1%}, peak {stats['peak_bytes'] / 2**30:.3f} GiB")
    else:
        card = "device not measured (no card)"
    print(f"# {name}: {n_pairs} pairs, {warmup} + {iters} calls, {qps:.2f} pairs/s, wall "
          f"{stats['wall_ms']:.3f} ms/call; {card}", flush=True)
    return {**stats, "out": out}


def run(cfg: Config | None = None, device: str | torch.device = "cuda", batch: int = BATCH,
        iters: int = ITERS, warmup: int = WARMUP, *, report: dict | None = None) -> dict:
    """The four paths on one model → the JAX bench's row. ``report``, when
    given, receives each path's numbers and last output (by the row's
    figure name), the model, its anchors and the device batches."""
    dev = resolve_device(device)
    cfg = (cfg or bench_cfg()).replace(bs=batch, quant_mode="int8")
    model = get_default_net(cfg, VOCAB, device=dev)
    anchors = torch.as_tensor(anchor_pyramid_for(cfg), device=dev)
    flat, grouped = (to_device(b, dev) for b in make_batches(cfg, batch))

    def path(name: str, b: dict, mode: str) -> dict:
        set_quant_mode(model, mode)
        if quant_modes(model) != {mode}:
            raise AssertionError(f"{name}: quantizable modules in modes {quant_modes(model)}, not {mode!r}")
        n_pairs = b["qvec"].shape[:-1].numel()
        return time_path(name, lambda: infer(model, anchors, b["img"], b["qvec"], b["qlens"]), n_pairs, dev,
                         warmup, iters)

    res = {"value": path("value", flat, "off")}
    calibrate(model, flat)  # after the bf16 timing, as the JAX bench orders it
    res["int8"] = path("int8", flat, "int8")
    res["grouped_q5"] = path("grouped_q5", grouped, "off")
    res["grouped_q5_int8"] = path("grouped_q5_int8", grouped, "int8")
    if report is not None:
        report.update(res, model=model, anchors=anchors, flat=flat, grouped=grouped)
    qps = {k: r["qps"] for k, r in res.items()}
    return {
        "metric": "grounding_queries_per_sec_per_chip",
        "value": round(qps["value"], 2),
        "unit": "qps",
        "vs_baseline": round(qps["value"] / V100_REF_QPS, 3),
        "int8_qps": round(qps["int8"], 2),
        "int8_vs_baseline": round(qps["int8"] / V100_REF_QPS, 3),
        "grouped_q5_qps": round(qps["grouped_q5"], 2),
        "grouped_q5_vs_baseline": round(qps["grouped_q5"] / V100_REF_QPS, 3),
        "grouped_q5_int8_qps": round(qps["grouped_q5_int8"], 2),
        "grouped_q5_int8_vs_baseline": round(qps["grouped_q5_int8"] / V100_REF_QPS, 3),
    }


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    dev = resolve_device(device)
    if dev.type == "cuda":
        print(card_line(), flush=True)
    print(json.dumps(run(device=dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
