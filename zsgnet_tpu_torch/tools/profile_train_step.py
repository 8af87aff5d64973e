"""Where the train step's time goes on the card, by kernel category.

    python -m zsgnet_tpu_torch.tools.profile_train_step [B] [--remat] [--canvas] [--notrace]
        [--resize=300] [--grad_accum=1] [--spd] [--infer]

Counterpart of ``tools/profile_train_step.py``: the train step
(``parallel.train_step.make_train_step``: the default retina model, bf16
convolutions, K1 and K2, Adam) at batch B (default 128) on a seeded batch
(uint8 images, vocab 10000, query lengths 3–11, random gt boxes, drawn in
the JAX tool's order), kept in pinned host memory: each step uploads it.
``--infer`` times the forward and the top-anchor decode instead. After 3
steps it prints the peak memory allocated and the wall ms per step over 30
steps closed by a value fetch; then, unless ``--notrace``, the card's
kernels over 3 profiled steps (``torch.profiler``), summed by
:func:`category` (cuDNN's convolution forward, dgrad and wgrad kernels,
convolutions run as GEMMs, BatchNorm forward and backward, NCHW↔NHWC
layout copies, the LSTM, K1 and K2, the optimizer's multi-tensor kernels,
other), and the top 30 kernels.

Not ported: ``--vmem`` (the Pallas kernels' VMEM budget on the TPU) and
``--bnfast``, ``--bnshift``, ``--bnshift16`` (the JAX package's BatchNorm
variance modes; the port trains the exact two-pass variance in every mode).
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import numpy as np
import torch

from zsgnet_tpu_torch.bench import VOCAB, card_line, flat_batch, infer
from zsgnet_tpu_torch.config import Config, get_default_cfg
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step
from zsgnet_tpu_torch.tools.bench_grouped_train import host_batch
from zsgnet_tpu_torch.utils.backend import resolve_device
from zsgnet_tpu_torch.utils.profiling import device_kernels

STEPS = 30
TRACE_STEPS = 3
TOP = 30
FLAGS = ("--remat", "--canvas", "--notrace", "--resize=", "--grad_accum=", "--spd", "--infer")

# (category, lower-case name fragments), first match wins: dgrad and wgrad
# before the forward's generic cuDNN names, the loss kernels before all.
# cuDNN runs some convolutions (the 1×1 ones) as cuBLAS/CUTLASS GEMMs, whose
# names do not say the direction: "conv as GEMM". The model has no other
# GEMM but the LSTM's, which is a few microseconds a step.
CATEGORIES = (
    ("loss K1", ("match_loss_row",)),
    ("loss K2", ("match_loss_grads",)),
    ("conv dgrad", ("dgrad",)),
    ("conv wgrad", ("wgrad",)),
    ("batchnorm backward", ("bn_bw", "batch_norm_backward", "bn_bwd")),
    ("batchnorm forward", ("bn_fw", "batch_norm_collect", "batch_norm_elemt", "batch_norm_transform",
                           "batch_norm_elementwise", "bn_fwd")),
    ("layout copy", ("nchwtonhwc", "nhwctonchw", "nchw2nhwc", "nhwc2nchw")),
    ("lstm", ("lstm", "rnn")),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("conv forward", ("fprop", "convolve", "conv2d", "implicit_gemm", "xmma_fwd")),
    ("conv as GEMM", ("gemm",)),
)


def category(name: str) -> str:
    """The category of a CUDA kernel, by its name."""
    low = name.lower()
    return next((cat for cat, frags in CATEGORIES if any(f in low for f in frags)), "other")


def by_category(rows: list[tuple[str, float]]) -> dict[str, float]:
    """(kernel name, ms) pairs → ms per category, largest first."""
    agg: dict[str, float] = defaultdict(float)
    for name, ms in rows:
        agg[category(name)] += ms
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]))


def train_batch(rng: np.random.Generator, cfg: Config, b: int) -> dict:
    """The headline bench's flat draw (images, queries, lengths), then gt
    boxes."""
    batch = flat_batch(rng, cfg, b)
    batch["annot"] = np.stack([rng.uniform(-0.9, -0.1, size=(b, 2)), rng.uniform(0.1, 0.9, size=(b, 2))],
                              axis=1).reshape(b, 4).astype(np.float32)
    return batch


def bench(b: int = 128, device: str | torch.device = "cuda", cfg: Config | None = None, *, remat: bool = False,
          canvas: bool = False, notrace: bool = False, resize: int = 300, grad_accum: int = 1, spd: bool = False,
          infer_only: bool = False, steps: int = STEPS) -> dict:
    """{"wall_ms", "qps", "peak_bytes"} and, unless ``notrace`` (or off the
    card), {"device_ms", "launches", "categories", "top"}."""
    dev = resolve_device(device)
    cfg = (cfg or get_default_cfg()).replace(
        bs=b, do_dist=False, remat_backbone=remat, head_canvas=canvas, resize_img=(resize, resize),
        spd_stem=spd, grad_accum=grad_accum)
    model = get_default_net(cfg, VOCAB, device=dev)
    batch = train_batch(np.random.default_rng(0), cfg, b)
    if infer_only:
        anchors = torch.as_tensor(anchor_pyramid_for(cfg), device=dev)
        img, qvec = (torch.from_numpy(batch[k]).to(dev) for k in ("img", "qvec"))
        qlens = torch.from_numpy(batch["qlens"])

        def run():
            box, _ = infer(model, anchors, img, qvec, qlens)
            return box.sum()
    else:
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, anchor_pyramid_for(cfg), device=dev)
        hb = host_batch(batch, dev)

        def run():
            return step(state, hb)[1]["total"]

    print(f"B={b} remat={remat} canvas={canvas} grad_accum={grad_accum} infer={infer_only} device={dev}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        total = run()
    float(total)
    res: dict = {"peak_bytes": None}
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        print(f"peak memory allocated: {res['peak_bytes'] / 2**30:.2f} GiB "
              f"(card {torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f} GiB)", flush=True)
    t0 = time.perf_counter()
    for _ in range(steps):
        total = run()
    float(total)  # the fetch waits for every queued step
    wall = (time.perf_counter() - t0) / steps
    res.update(wall_ms=wall * 1e3, qps=b / wall)
    print(f"wall: {wall * 1000:.1f} ms/step  {b / wall:.0f} qps", flush=True)
    if notrace or dev.type != "cuda":
        return res

    kernels = device_kernels(run, TRACE_STEPS)
    res["device_ms"] = sum(t for _, t, _ in kernels)
    res["launches"] = sum(n for *_, n in kernels)
    res["categories"] = by_category([(k, t) for k, t, _ in kernels])
    res["top"] = kernels[:TOP]
    total_ms = res["device_ms"]
    print(f"\ndevice total: {total_ms:.1f} ms/step in {res['launches']:.0f} launches (traced {TRACE_STEPS})")
    print("\nby category (ms/step):")
    for k, v in res["categories"].items():
        print(f"  {k:22s} {v:8.2f}  ({100 * v / total_ms:4.1f}%)")
    print(f"\ntop {TOP} kernels (ms/step, launches/step):")
    for k, t, n in res["top"]:
        print(f"  {t:8.3f}  {n:5.0f}  {category(k):20s} {k[:100]}")
    sys.stdout.flush()
    return res


def main(argv: list[str]) -> int:
    unknown = [a for a in argv if not a.isdigit() and not a.startswith(FLAGS)]
    if unknown:
        raise SystemExit(f"profile_train_step: unknown or TPU-only flags {unknown} (see the module docstring)")

    def value(flag: str, default: int) -> int:
        return next((int(a.split("=", 1)[1]) for a in argv if a.startswith(flag)), default)

    b = next((int(a) for a in argv if a.isdigit()), 128)
    dev = resolve_device("cuda")
    print(card_line(), flush=True)
    bench(b, dev, remat="--remat" in argv, canvas="--canvas" in argv, notrace="--notrace" in argv,
          resize=value("--resize=", 300), grad_accum=value("--grad_accum=", 1), spd="--spd" in argv,
          infer_only="--infer" in argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
