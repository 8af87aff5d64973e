"""Smoke run of zsgnet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the package's CUDA kernels from ``zsgnet_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version, then drives the port's
paths at the full width of the default retina model at 300² (ResNet-50 +
FPN 256, head 256, embedding 300, BiLSTM 256, 9 anchors, bf16
convolutions) with seeded random weights on a synthetic dataset:
evaluation over the validation split, a ``Grounder`` answering 1 and then
16 requests, and training through ``main_dist`` (one epoch of Adam steps,
validation, checkpoints), then a reload, step timings and an overfit run,
and layer1 of the same model through the fused inference bottleneck
(K3) against the eager layer1, with K3's timings from
``zsgnet_tpu_torch.tools.bench_bottleneck`` (the Hopper kernel beside the
``mma.sync`` kernel, same inputs, same run). The loss kernels K1 and K2
are checked on random inputs, on rows whose positives hang on the argmax
anchor and on non-finite deltas, and timed side by side through
``zsgnet_tpu_torch.tools.bench_loss``. Phase 8 serves the checkpoint that
phase 6's ``main_dist`` wrote: ``Grounder.from_checkpoint`` on the run
directory and its ``best/``, the shape buckets and ``ground_image`` against
the full-batch and per-pair paths (float32), open-vocabulary slots,
``batch_predict`` grouped against flat, and the HTTP daemon of
``zsgnet_tpu_torch.serve`` under 32 clients and under a burst with
``max_queue=4``, then their timings in bf16; no kernel launches there.
Phase 10 takes the same checkpoint through the serving formats: the canvas
head against the per-level head (float32 equal, bf16 in range, launches and
wall time at buckets 1 and 16 in turns), int8 (calibrated on the first
batch, ``torch._int_mm`` held against its plain version on the model's
convolutions, int8 against bf16 at B = 32 and 64, the share of int8 boxes
with IoU ≥ 0.5 against bf16), and ``torch.export`` artifacts (float32 v3
with multi-query programs, bf16 v1) loaded in a fresh process and held
against the live Grounders, timed beside them, and served by the daemon;
no kernel launches there either. It runs last, after phase 7.
Phase 9 drives the model and training variants: grouped multi-query
training to ``configs/flickr30k_grouped.json`` (24 images × 5 phrases,
K1/K2 at B = 120 on its outputs, float32 grouped validation against flat,
the grouped step against a flat step of the same 120 pairs in turns),
SSD-VGG16 with per-level heads (A = 17460), and remat against no remat.
Phase 11, after phase 7, drives the host data path and the operator tools
on phase 6's data and checkpoint: the native image library (built with g++
on the card's host; every PNG must decode through it), decode ms native
against PIL, the loader's host ms per batch (CSV, PIL only, packed cache,
host normalization), serving decode, one epoch of ``main_dist`` through the
packed cache (its first batch byte-equal to the CSV path's, K1 and K2 once
a step), ``time_fn`` and ``profile_trace`` on the eval step, then
``python -m zsgnet_tpu_torch.doctor``, ``demo`` and ``viz`` as processes of
their own and ``ckpt_info`` on the checkpoint and the demo's artifact.
Phase 12, after phase 11, drives data parallel on the one card: (a)
``python -m torch.distributed.run --nproc_per_node=1`` on this script's
worker, which runs the command line's ``main()`` with ``--multi_host=True``
(NCCL, world 1) for one epoch and holds its log row and K1/K2 launches
(10/4) against a plain ``main_dist`` of the same config and seed, then times
the data-parallel train step against the plain one in turns; (b) two gloo
ranks sharing ``cuda:0`` (B = 8 each of the global 16, float32, lr 1e-6)
against one process on the same global batches (per-step losses,
parameters, BatchNorm statistics, validation), K1 and K2 held on each
rank's outputs, one launch each per step and rank, and the all-reduce's
share of the step from the profiler (gloo on one card: not a scaling
figure); (c) ``load_server_model(data_parallel=True)`` and a two-replica
``Grounder`` against the single-device one in float32, with no kernel
launch.
Phase 13, after phase 12, drives spatial partitioning on the one card:
``torch.distributed.run --nproc_per_node=2`` on this script's
``--sp-worker``: two gloo ranks sharing ``cuda:0`` with ``mesh_spatial=2``,
each rank half of every image's rows, against one process on the same
batches (losses, ``num_pos``, the parameters and BatchNorm statistics
after the steps, an eval step's loss and IoU), logging where the reshard
landed, each rank's peak memory against the one process's and the time
under ``sp::halo`` and ``sp::reshard``, with K1 and K2 once a step a rank
on its post-reshard block, held against their plain versions: (a) retina
and (a′) SSD-VGG16, its VGG tower split by height, at 600² and at 300² (3
float32 steps of B = 4, lr 1e-6); (a″) SSD-VGG16 at 600² and B = 1 (2
steps; the members gather the one sample, each weighing its copy of the
loss 1/2), and the retina Learner's validation at 600² and B = 1. (b)
``Grounder(mesh_spatial=2)`` on ``["cuda:0", "cuda:0"]`` against the plain
Grounder at buckets 1 and 16 in float32 and in int8, and (b′) the same with
phase 9's SSD-VGG16 checkpoint in float32; (c) ``serve.py --mesh_spatial=2``
as a process answering requests; no kernel launch in (b), (b′) and (c).
Gloo on one card: not a scaling figure.
Phase 14, after phase 13, runs the headline benchmark's protocol:
``zsgnet_tpu_torch.bench.run`` at B = 128 (3 + 100 calls each of bf16,
int8, grouped 26 × 5 and grouped int8; no K1/K2/K3 launch), its bf16 boxes
against ``Grounder._infer`` on the same model and batch, its grouped path
against the flat path on each image tiled 5 times in float32, the share of
int8 boxes with IoU ≥ 0.5 against bf16, then the measurement tools once
each at their default sizes (``profile_bench``, ``bench_infer_ab``,
``bench_grouped_train``, ``profile_train_step`` traced); the bench's row is
printed on a line of its own.
Each path is driven with the kernels' launch counts set to 0 just before
it and read just after. Every phase is fatal on failure. The
next-to-last line of standard output is a JSON object describing each
kernel; the last is ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from zsgnet_tpu_torch.utils.profiling import device_kernels

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12  # bf16 tensor cores, dense
# Float operations per (row, anchor) in csrc/fused_loss.cu's loop body,
# counting each transcendental (exp, log1p, pow, log) as one: IoU 17,
# labels 3, focal 30, targets 16, smooth-L1 and the sums 30, the delta's
# finiteness 4.
K1_OPS_PER_ELEMENT = 100
# The same for K2's kernel at every (row, anchor): IoU 17, labels 3, focal
# gradient with one exp 34, datt's products and select 3, dbbx's zero 1;
# and at a positive one: targets 16, four smooth-L1 gradients 20, their
# products with g_box and w 8.
K2_OPS_PER_ELEMENT = 58
K2_OPS_PER_POSITIVE = 44
BATCH = 16
N_TRAIN = 64  # 4 steps of BATCH per epoch
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def check_fused_loss(anchors_cthw: np.ndarray) -> dict:
    """Phase 3: K1 against its plain version on the card, one kernel launch
    per call, bit-identical on repeat."""
    from zsgnet_tpu_torch.ops.cuda import fused_loss as fl
    from zsgnet_tpu_torch.tools.bench_loss import random_inputs

    dev = torch.device("cuda")
    att, bbx, gt, w = (torch.from_numpy(x).to(dev) for x in random_inputs(
        anchors_cthw, BATCH, np.random.default_rng(SEED)))
    anc = fl.pack_anchors(anchors_cthw, dev)
    got = fl.fused_match_loss(att, bbx, *anc, gt, w)
    want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w)
    torch.cuda.synchronize()
    got_c, want_c = got.double().cpu(), want.double().cpu()
    log(f"K1 kernel {got_c.tolist()} plain {want_c.tolist()}")
    if got_c[2] != want_c[2]:
        raise AssertionError(f"K1 num_pos {got_c[2]} != plain {want_c[2]}")
    if not torch.allclose(got_c[:2], want_c[:2], rtol=1e-4, atol=0.0):
        raise AssertionError(f"K1 sums {got_c[:2]} disagree with plain {want_c[:2]} (rtol 1e-4)")
    # The tie row alone: the kernel must promote anchor 0 (first of the ties).
    tie = fl.fused_match_loss(att[1:2], bbx[1:2], *anc, gt[1:2], w[1:2])
    if float(tie[2]) != 1.0:
        raise AssertionError(f"tie row has num_pos {float(tie[2])}, expected 1")

    kernels = device_kernels(lambda: fl.fused_match_loss(att, bbx, *anc, gt, w), 20)
    per_call = sum(n for *_, n in kernels)
    if len(kernels) != 1 or per_call != 1:
        raise AssertionError(f"K1 must be one kernel launch per call, the profile shows {kernels}")
    again = fl.fused_match_loss(att, bbx, *anc, gt, w)
    if not torch.equal(again, got):
        raise AssertionError(f"K1 is not bit-identical on repeat: {again.tolist()} vs {got.tolist()}")
    return {
        "name": "fused_match_loss_fwd",
        "route": "cuda",
        "source": "zsgnet_tpu_torch/csrc/fused_loss.cu",
        "replaces": "zsgnet_tpu/ops/pallas/fused_loss.py:151",
        "launches": 0,
        "kernel_launches_per_call": int(per_call),
        "max_abs_err": float((got_c - want_c).abs().max()),
        "library_ms": None,
    }


def _held(name: str, got, want, atol: float) -> float:
    """Max abs difference of two tensor tuples with NaN positions equal
    (fatal beyond ``atol`` or at another NaN or infinity)."""
    err = 0.0
    for g, x in zip(got, want):
        g, x = g.double().cpu().numpy(), x.double().cpu().numpy()
        np.testing.assert_allclose(g, x, atol=atol, rtol=0, equal_nan=True, err_msg=name)
        fin = np.isfinite(x)
        err = max(err, float(np.abs(g[fin] - x[fin]).max(initial=0.0)))
    return err


def check_fused_loss_backward(anchors_cthw: np.ndarray) -> dict:
    """Phase 3b: K2 against its plain version on the card (random inputs;
    the promotion case at A = 17451, whose rows' positives hang on promoted
    and tied argmax anchors, with zero-weight rows; non-finite deltas, where
    K2 takes its positive-only branch and K1 its NaN box sum), the
    elementwise kernel beside it, and the Function's gradients against
    autograd of the plain forward."""
    from zsgnet_tpu_torch.ops.cuda import fused_loss as fl
    from zsgnet_tpu_torch.tools.bench_loss import random_inputs
    from zsgnet_tpu_torch.tools.loss_cases import k1_promotion_case, nonfinite_case

    dev = torch.device("cuda")
    att, bbx, gt, w = (torch.from_numpy(x).to(dev) for x in random_inputs(
        anchors_cthw, BATCH, np.random.default_rng(SEED + 1)))
    anc = fl.pack_anchors(anchors_cthw, dev)
    sums, best = fl._launch_fwd(att, bbx, *anc, gt, w, 0.5, 0.4, 0.25, 2.0)
    n = sums[2].clamp(min=1.0)
    grad = torch.stack([1.0 / n, 1.0 / n, torch.zeros_like(n)])  # d total / d sums, lamb_reg 1
    got = fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)
    want = fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad)
    err = _held("K2 vs plain", got, want, 1e-6)
    _held("the elementwise K2 vs plain", fl.launch_bwd_variant("elementwise", att, bbx, *anc, gt, w, best, grad),
          want, 1e-6)
    log(f"K2 kernel vs plain: max abs error {err:.3e} (datt max {float(want[0].abs().max()):.4f}, "
        f"dbbx max {float(want[1].abs().max()):.4f})")

    c = k1_promotion_case(BATCH, anchors_cthw.shape[0], SEED)
    p_att, p_bbx, p_gt, p_w = (torch.from_numpy(c[k]).to(dev) for k in ("att", "bbx", "gt", "w"))
    p_anc = fl.pack_anchors(c["anchors_cthw"], dev)
    _, p_best = fl._launch_fwd(p_att, p_bbx, *p_anc, p_gt, p_w, 0.5, 0.4, 0.25, 2.0)
    if p_best.tolist() != c["best"].tolist():
        raise AssertionError(f"K1's argmax anchors {p_best.tolist()} on the promotion case, built for {c['best'].tolist()}")
    p_grad = torch.tensor([0.3, -1.1, 0.0], device=dev)
    p_want = fl.fused_match_loss_backward_reference(p_att, p_bbx, *p_anc, p_gt, p_w, p_grad)
    p_err = _held("K2 vs plain, promotion case",
                  fl.fused_match_loss_backward(p_att, p_bbx, *p_anc, p_gt, p_w, p_best, p_grad), p_want, 1e-6)
    _held("the elementwise K2 vs plain, promotion case",
          fl.launch_bwd_variant("elementwise", p_att, p_bbx, *p_anc, p_gt, p_w, p_best, p_grad), p_want, 1e-6)
    log(f"K2 vs plain on the promotion case (B={BATCH}, A={anchors_cthw.shape[0]}): max abs error {p_err:.3e}")

    # NaN in a positive anchor's delta: dbbx NaN there; +inf in a negative
    # anchor's: K1's box sum NaN, K2's dbbx 0 there.
    for value, label in (("nan", "positive"), ("inf", "negative")):
        c = nonfinite_case(float(value), "bbx", label, 1.0)
        n_att, n_bbx, n_gt, n_w = (torch.from_numpy(c[k]).to(dev) for k in ("att", "bbx", "gt", "w"))
        n_anc = fl.pack_anchors(c["anchors_cthw"], dev)
        n_sums, n_best = fl._launch_fwd(n_att, n_bbx, *n_anc, n_gt, n_w, 0.5, 0.4, 0.25, 2.0)
        _held(f"K1 vs plain, {value} in a {label} delta", (n_sums,),
              (fl.fused_match_loss_reference(n_att, n_bbx, *n_anc, n_gt, n_w),), 1e-4 * float(n_sums[0]))
        n_grad = torch.tensor([0.4, 1.3, 0.0], device=dev)
        n_got = fl.fused_match_loss_backward(n_att, n_bbx, *n_anc, n_gt, n_w, n_best, n_grad)
        _held(f"K2 vs plain, {value} in a {label} delta", n_got,
              fl.fused_match_loss_backward_reference(n_att, n_bbx, *n_anc, n_gt, n_w, n_grad), 1e-6)
        r, a = c["at"]
        elem = float(n_got[1][r, a, 1])
        if not (np.isnan(float(n_sums[1])) and (np.isnan(elem) if label == "positive" else elem == 0.0)):
            raise AssertionError(f"{value} in a {label} delta: box sum {float(n_sums[1])}, dbbx there {elem}")
        log(f"K1/K2 with {value} in a {label} anchor's delta: box sum {float(n_sums[1])}, dbbx there {elem} "
            "(as the plain version and the JAX kernel)")

    a1, b1 = att.clone().requires_grad_(), bbx.clone().requires_grad_()
    fl.zsg_loss_fused(a1, b1, anc, gt, sample_weight=w)["total"].backward()
    a2, b2 = att.clone().requires_grad_(), bbx.clone().requires_grad_()
    ref = fl.fused_match_loss_reference(a2, b2, *anc, gt, w)
    ((ref[0] + ref[1]) / ref[2].clamp(min=1.0)).backward()
    fn_err = max(float((a1.grad - a2.grad).abs().max()), float((b1.grad - b2.grad).abs().max()))
    log(f"K1+K2 Function gradients vs autograd of the plain forward: max abs error {fn_err:.3e}")
    if fn_err > 1e-6:
        raise AssertionError(f"the Function's gradients differ from autograd by {fn_err} (atol 1e-6)")
    return {
        "name": "fused_match_loss_bwd",
        "route": "cuda",
        "source": "zsgnet_tpu_torch/csrc/fused_loss.cu",
        "replaces": "zsgnet_tpu/ops/pallas/fused_loss.py:199",
        "launches": 0,
        "max_abs_err": max(err, p_err),
        "library_ms": None,
    }


def loss_timings(k1: dict, k2: dict) -> None:
    """Phase 3c: K1 and K2's kernels timed side by side on the same inputs
    through ``zsgnet_tpu_torch.tools.bench_loss``; fills their entries of
    the kernels line."""
    from zsgnet_tpu_torch.tools.bench_loss import bench

    r = bench(BATCH)
    b, a = r["shape"]
    k1["bound_ms"], k1["bound_by"] = _bound(r["k1_bytes"], b * a * K1_OPS_PER_ELEMENT)
    k2["bound_ms"], k2["bound_by"] = _bound(r["k2_bytes"], b * a * K2_OPS_PER_ELEMENT + r["positives"] * K2_OPS_PER_POSITIVE)
    k2["bound_ref_ms"] = r["k2_bytes_every_anchor"] / H100_BYTES_PER_S * 1e3
    k1.update(ms=r["k1_ms"], device_ms=r["k1_device_ms"], plain_ms=r["k1_plain_ms"])
    k2.update(ms=r["k2_ms"], device_ms=r["k2_device_ms"], plain_ms=r["k2_plain_ms"], kernel=r["k2_kernel"],
              **{k: v for k, v in r.items() if k.startswith("k2_") and k.endswith("device_ms") and k != "k2_device_ms"})
    log(f"K1 B={b} A={a}: {r['k1_ms']:.4f} ms per call back to back, device {r['k1_device_ms']:.4f} ms, plain "
        f"{r['k1_plain_ms']:.4f} ms, bound {k1['bound_ms'] * 1e3:.3f} us by {k1['bound_by']} "
        f"({r['k1_bytes'] / 1e6:.2f} MB), {k1['bound_ms'] / r['k1_device_ms']:.1%} of it reached")
    side = ", ".join(f"{k[3:-10]} {r[k]:.4f}" for k in r if k.startswith("k2_") and k.endswith("_device_ms")
                     and k != "k2_device_ms")
    log(f"K2 B={b} A={a} ({r['positives']} positive anchors): kernel {r['k2_kernel']}, {r['k2_ms']:.4f} ms per call "
        f"back to back, device {r['k2_device_ms']:.4f} ms; side by side on the card: {side} ms; plain "
        f"{r['k2_plain_ms']:.4f} ms; bound {k2['bound_ms'] * 1e3:.3f} us by {k2['bound_by']} "
        f"({r['k2_bytes'] / 1e6:.2f} MB), {k2['bound_ms'] / r['k2_device_ms']:.1%} of it reached; bound counting "
        f"bbx and cthw at every anchor {k2['bound_ref_ms'] * 1e3:.3f} us ({r['k2_bytes_every_anchor'] / 1e6:.2f} MB), "
        f"{k2['bound_ref_ms'] / r['k2_device_ms']:.1%}")
    if not r["k2_device_ms"] < r["k2_elementwise_device_ms"]:
        raise AssertionError(f"K2 ({r['k2_device_ms']} ms on the card) is not faster than the elementwise kernel "
                             f"({r['k2_elementwise_device_ms']} ms) in the same run")


def check_small_against_cpu() -> None:
    """The port on the card against the port on the CPU at a small float32
    size (the CPU path is held against the JAX package by the tests): the
    eval step, then 3 train steps. The train steps run at lr 1e-6: at this
    size the trajectory is chaotic at larger rates (tests/test_torch_train_step.py)."""
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.parallel.train_step import (
        create_train_state, make_eval_step, make_train_step,
    )

    cfg = Config(resize_img=(64, 64), max_qlen=8, lstm_dim=8, emb_dim=8, fpn_ch=16,
                 head_ch=16, compute_dtype="float32", use_level_path=False, lr=1e-6)
    rng = np.random.default_rng(SEED)
    batch = {
        "img": rng.integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8),
        "qvec": rng.integers(1, 30, size=(4, 8)).astype(np.int32),
        "qlens": np.array([3, 8, 1, 5], np.int32),
        "annot": np.array([[-0.6, -0.5, 0.2, 0.3], [-0.2, -0.9, 0.5, 0.1],
                           [0.0, 0.0, 0.7, 0.8], [-1.0, -1.0, 1.0, 1.0]], np.float32),
        "valid": np.array([True, True, True, False]),
    }
    anchors = anchor_pyramid_for(cfg)
    res = {}
    for dev in ("cpu", "cuda"):
        model = get_default_net(cfg, 30, seed=SEED, device=dev)
        ev = make_eval_step(cfg, anchors, device=dev)(model, batch)
        res[dev] = {k: v.cpu() for k, v in ev.items()}
    for k in ("iou", "pred_box", "loss"):
        if not torch.allclose(res["cuda"][k], res["cpu"][k], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"small eval step {k}: cuda {res['cuda'][k]} vs cpu {res['cpu'][k]}")
    log(f"small eval step cuda == cpu: loss {float(res['cuda']['loss'][0]):.6f} "
        f"vs {float(res['cpu']['loss'][0]):.6f}")
    losses = {}
    for dev in ("cpu", "cuda"):
        state = create_train_state(cfg, get_default_net(cfg, 30, seed=SEED, device=dev))
        step = make_train_step(cfg, anchors, device=dev)
        losses[dev] = [float(step(state, batch)[1]["total"]) for _ in range(3)]
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-3, atol=0.0):
        raise AssertionError(f"small train steps: cuda {losses['cuda']} vs cpu {losses['cpu']}")
    log(f"small train steps cuda == cpu (rtol 1e-3): {losses['cuda']} vs {losses['cpu']}")


def check_training(data_dir: str, run_dir: str) -> tuple[int, int]:
    """Phase 6, the training path: one epoch of training at full width
    through ``main_dist`` (N_TRAIN rows, bf16, Adam, validation,
    checkpoints); then a fresh Learner restored from the checkpoint must
    give the same validation metrics, the step is timed and profiled, and
    ``overfit_batch(30)`` must lower the loss. Returns the (K1, K2) launch
    counts of the ``main_dist`` run."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.main import main_dist
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward
    from zsgnet_tpu_torch.train.learner import Learner

    kw = dict(ds_to_use="synthetic", data_dir=data_dir, tmp_path=run_dir, epochs=1, bs=BATCH,
              seed=SEED, log_every=1)
    fused_match_loss.launches = fused_match_loss_backward.launches = 0
    t0 = time.perf_counter()
    metrics = main_dist("smoke", device="cuda", **kw)
    torch.cuda.synchronize()
    launches = (fused_match_loss.launches, fused_match_loss_backward.launches)
    rows = [json.loads(x) for x in (Path(run_dir) / "logs" / "smoke.jsonl").read_text().splitlines()]
    log(f"main_dist: 1 epoch of {rows[-1]['step']} steps + validation in "
        f"{time.perf_counter() - t0:.2f} s; K1 launches {launches[0]}, K2 launches {launches[1]}; "
        f"log row {rows[-1]}")
    if launches[1] == 0:
        raise AssertionError("the training path never launched K2")
    if rows[-1]["step"] != N_TRAIN // BATCH or not np.isfinite(rows[-1]["train_total"]):
        raise AssertionError(f"training log row {rows[-1]}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"validation metrics {metrics}")

    cfg = get_default_cfg().replace(uid="smoke", resume=True, **kw)
    data = get_data(cfg)
    learn = Learner("smoke", data, cfg, device="cuda")
    again = learn.validate()
    if (again["Acc"], again["MaxPos"], again["num_samples"]) != (
            metrics["Acc"], metrics["MaxPos"], metrics["num_samples"]) or not np.allclose(
            [again["MeanIoU"], again["loss"]], [metrics["MeanIoU"], metrics["loss"]], rtol=1e-4):
        raise AssertionError(f"reloaded checkpoint validates to {again}, the run to {metrics}")
    log(f"checkpoint step {learn.state.step} reloaded into a fresh Learner: validation {again}")

    batches = list(data.train_dl)
    step = learn.train_step
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(12):
        t0 = time.perf_counter()
        learn.state, ls = step(learn.state, batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(ls["total"]):
            raise AssertionError(f"non-finite training loss at timing step {i}")
    warm = times[2:]
    median = statistics.median(warm)
    fused_match_loss.launches = fused_match_loss_backward.launches = 0
    kernels = device_kernels(lambda: step(learn.state, batches[0]), 3)
    per_step = (fused_match_loss.launches / 4, fused_match_loss_backward.launches / 4)
    busy = sum(t for _, t, _ in kernels)
    log(f"train step B={BATCH} bf16 Adam: median {median:.3f} ms over {len(warm)} warm steps "
        f"(all {[round(t, 2) for t in times]}); device time {busy:.3f} ms/step in "
        f"{sum(n for *_, n in kernels)} kernel launches (idle {1 - busy / median:.1%} of the "
        f"median step); K1 and K2 launches per step {per_step}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"train step top kernels: {[(k[:60], round(t, 4), n) for k, t, n in kernels[:10]]}")
    if per_step != (1.0, 1.0):
        raise AssertionError(f"K1/K2 launches per train step {per_step}, expected 1 each")

    first, last = learn.overfit_batch(30)
    log(f"overfit_batch(30): first loss {first:.6f}, last {last:.6f}")
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"overfit_batch did not lower the loss: {first} -> {last}")
    return launches


def _post(url: str, payload: dict) -> tuple[int, dict, dict, float]:
    """POST /ground → (status, body, headers, seconds)."""
    req = urllib.request.Request(url + "/ground", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers), time.perf_counter() - t0


def _serve(grounder, **kw):
    from zsgnet_tpu_torch.serve import make_server

    srv = make_server(grounder, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _best_anchors(g, images: list, queries: list, pad_to: int, shared: bool = False) -> list[int]:
    """The flat argmax anchor of each request when the chunk is padded to
    ``pad_to`` rows (``shared``: one image against the queries, as
    ``ground_image`` runs it)."""
    from zsgnet_tpu_torch.predict import encode_queries, load_image, prep_chunk

    if shared:
        img = load_image(images[0], g.cfg.resize_img)[0][None].copy()
        qvec, qlens = encode_queries(g.cfg, g.vocab, pad_to, queries)
    else:
        img, qvec, qlens, _, _ = prep_chunk(g.cfg, g.vocab, pad_to, images, queries)
    with torch.inference_mode():
        att = g.model(torch.from_numpy(img).cuda(), torch.from_numpy(qvec).cuda(), torch.from_numpy(qlens))["att_out"]
    return att.argmax(dim=-1)[: len(queries)].tolist()


def _held_results(name: str, got: list, want: list, anchors: tuple | None = None, tol: float = 1e-4) -> float:
    """Scores within ``tol``; boxes within ``tol`` (normalized) for every
    request, or, given (got, want) anchors, wherever both picked the same
    one. Returns the largest score difference."""
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} results for {len(want)} requests")
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        d_score = abs(a["score"] - b["score"])
        d_box = float(np.abs(np.subtract(a["box_norm"], b["box_norm"])).max())
        err = max(err, d_score)
        same = anchors is None or anchors[0][i] == anchors[1][i]
        if d_score > tol or (same and d_box > tol):
            raise AssertionError(f"{name}, request {i}: {a} vs {b} (score {d_score:.2e}, box {d_box:.2e}, "
                                 f"tolerance {tol}; anchors {None if anchors is None else (anchors[0][i], anchors[1][i])})")
    return err


def _in_range(name: str, results: list) -> None:
    boxes = np.array([r["box_norm"] for r in results])
    scores = np.array([r["score"] for r in results])
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all() and np.abs(boxes).max() <= 1.0
            and scores.min() >= 0.0 and scores.max() <= 1.0):
        raise AssertionError(f"{name}: results out of range {results}")


def _median_ms(fn, runs: int = 5) -> float:
    lat = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def check_serving(model_dir: Path, data_root: Path, smi: str) -> list[int]:
    """Phase 8, serving, run after phase 6 on the checkpoint its ``main_dist``
    wrote: ``Grounder.from_checkpoint`` on the run's model directory and its
    ``best/`` store, the shape buckets, ``ground_image``, open-vocabulary
    slots, ``batch_predict`` and the daemon, held against the port's own
    full-batch and per-pair paths (float32 for exact comparisons: under
    bf16 cuDNN may pick other algorithms at another batch size), then timed
    in bf16. K1, K2 and K3 must not launch: returns their launch counts."""
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward
    from zsgnet_tpu_torch.predict import Grounder, batch_predict, prep_chunk

    kernels = (fused_match_loss, fused_match_loss_backward, fused_bottleneck_infer)
    for k in kernels:
        k.launches = 0
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    g = Grounder.from_checkpoint(model_dir, batch_size=BATCH, device="cuda")
    best = Grounder.from_checkpoint(model_dir / "best", batch_size=BATCH, device="cuda")
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    g.warmup(multiquery=True)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    best_sd = best.model.state_dict()
    if not all(torch.equal(v, best_sd[k]) for k, v in g.model.state_dict().items()):
        raise AssertionError("the run directory and its best/ store served different weights")
    log(f"serving: Grounder.from_checkpoint of {model_dir.name} and its best/ in {t_load:.2f} s "
        f"(cfg {g.cfg.resize_img} {g.cfg.compute_dtype}, vocab {len(g.vocab)}, buckets {g.bucket_sizes}); "
        f"warmup(multiquery=True) in {t_warm:.2f} s")
    del best, best_sd

    val = pd.read_csv(data_root / "csv_dir" / "val.csv")
    paths = [data_root / "images" / str(p) for p in val["img_id"]]
    queries = [str(q) for q in val["query"]]
    f32 = Grounder.from_checkpoint(model_dir, batch_size=BATCH, cfg_overrides={"compute_dtype": "float32"},
                                   device="cuda")
    f32_full = Grounder(f32.cfg, f32.vocab, f32.model.state_dict(), batch_size=BATCH, bucket_sizes=(BATCH,),
                        device="cuda")
    g_full = Grounder(g.cfg, g.vocab, g.model.state_dict(), batch_size=BATCH, bucket_sizes=(BATCH,), device="cuda")

    # Buckets: 1, 3 and 16 requests against the same requests padded to 16.
    for n in (1, 3, BATCH):
        pad = f32._pad_to(n)
        anchors = (_best_anchors(f32, paths[:n], queries[:n], pad), _best_anchors(f32, paths[:n], queries[:n], BATCH))
        err = _held_results(f"float32 bucket {pad} vs full batch", f32.ground(paths[:n], queries[:n]),
                            f32_full.ground(paths[:n], queries[:n]), anchors)
        got, want = g.ground(paths[:n], queries[:n]), g_full.ground(paths[:n], queries[:n])
        _in_range(f"bf16 bucket {pad}", got)
        bf_err = max(abs(a["score"] - b["score"]) for a, b in zip(got, want))
        bf_box = max(float(np.abs(np.subtract(a["box_norm"], b["box_norm"])).max()) for a, b in zip(got, want))
        log(f"serving: {n} request(s) through bucket {pad} vs padded to {BATCH}: float32 max score diff {err:.2e} "
            f"({sum(a == b for a, b in zip(*anchors))}/{n} same anchor); bf16 max score diff {bf_err:.2e}, "
            f"max box diff {bf_box:.2e}")

    # Multi-query: one image against 5 queries vs the image tiled 5 times.
    mq = queries[:5]
    img = paths[0]
    anchors = (_best_anchors(f32, [img], mq, 8, shared=True), _best_anchors(f32, [img] * 5, mq, 8))
    err = _held_results("float32 ground_image vs tiled ground", f32.ground_image(img, mq),
                        f32.ground([img] * 5, mq), anchors)
    got = g.ground_image(img, mq)
    _in_range("bf16 ground_image", got)
    bf_err = max(abs(a["score"] - b["score"]) for a, b in zip(got, g.ground([img] * 5, mq)))
    log(f"serving: ground_image of 5 queries vs ground of the image tiled 5 times: float32 max score diff "
        f"{err:.2e} ({sum(a == b for a, b in zip(*anchors))}/5 same anchor); bf16 max score diff {bf_err:.2e}")

    # Open vocabulary: 8 slots, two unseen words, rows as the host computes them.
    oov = Grounder.from_checkpoint(model_dir, batch_size=BATCH, oov_slots=8, device="cuda")
    n_vocab = len(oov.vocab)
    res = oov.ground(paths[:2], ["the zorblax box", "the quuxify ellipse"])
    _in_range("open vocabulary", res)
    rows = {w: oov.model.embedding.weight[oov.vocab.word_to_id[w]].detach().cpu().numpy()
            for w in ("zorblax", "quuxify")}
    for w, row in rows.items():
        want = np.random.default_rng(zlib.crc32(w.encode())).normal(0, oov._emb_scale, row.shape[0]).astype(np.float32)
        if not np.array_equal(row, want):
            raise AssertionError(f"open vocabulary: the row of {w!r} on the card is not the seeded row")
    if len(oov.vocab) != n_vocab + 2 or np.array_equal(rows["zorblax"], rows["quuxify"]):
        raise AssertionError(f"open vocabulary: vocab {n_vocab} -> {len(oov.vocab)}, rows distinct "
                             f"{not np.array_equal(rows['zorblax'], rows['quuxify'])}")
    log(f"serving: oov_slots=8 gave 'zorblax' and 'quuxify' ids {n_vocab} and {n_vocab + 1}, distinct seeded "
        f"rows (scale {oov._emb_scale:.4f}); scores {[round(r['score'], 5) for r in res]}")
    del oov

    # Bulk: the val split as it is, and its 40 queries over 10 of its images.
    with tempfile.TemporaryDirectory() as out:
        out = Path(out)
        grouped_csv = out / "grouped.csv"
        val.assign(img_id=[val["img_id"][i - i % 4] for i in range(len(val))]).to_csv(grouped_csv, index=False)
        for csv in (data_root / "csv_dir" / "val.csv", grouped_csv):
            t0 = time.perf_counter()
            n_g = batch_predict(f32, csv, data_root / "images", out / "g.jsonl", grouped=True)
            t_g = time.perf_counter() - t0
            n_f = batch_predict(f32, csv, data_root / "images", out / "f.jsonl", grouped=False)
            rows_g = [json.loads(x) for x in (out / "g.jsonl").read_text().splitlines()]
            rows_f = [json.loads(x) for x in (out / "f.jsonl").read_text().splitlines()]
            if n_g != n_f or n_g != len(val) or [(r["img_id"], r["query"]) for r in rows_g] != [
                    (r["img_id"], r["query"]) for r in rows_f]:
                raise AssertionError(f"batch_predict on {csv.name}: rows {n_g} grouped, {n_f} flat")
            err = _held_results(f"batch_predict on {csv.name}, grouped vs flat", rows_g, rows_f)
            log(f"serving: batch_predict {csv.name} ({n_g} rows, {len(set(r['img_id'] for r in rows_g))} images), "
                f"grouped vs flat, float32: max score diff {err:.2e}; grouped {t_g:.3f} s")

    # The daemon: 32 clients, four request forms, float32 answers against ground.
    pool_pairs = list(zip(paths[:BATCH], queries[:BATCH]))
    one = [f32.ground([p], [q])[0] for p, q in pool_pairs]
    full = f32.ground(paths[:BATCH], queries[:BATCH])
    stable = [i for i in range(BATCH)
              if float(np.abs(np.subtract(one[i]["box_norm"], full[i]["box_norm"])).max()) <= 1e-4]
    if len(stable) < BATCH // 2:
        raise AssertionError(f"only {len(stable)} of {BATCH} requests ground alike at batch 1 and {BATCH}")
    mq_want = {i: f32.ground([paths[i]] * 3, [queries[j] for j in stable[:3]]) for i in stable}
    b64 = {i: base64.b64encode(paths[i].read_bytes()).decode() for i in stable}

    def client(c: int) -> list:
        out = []
        for r in range(4):
            i = stable[(c * 4 + r) % len(stable)]
            form = (c + r) % 4
            if form == 0:
                payload, want = {"query": queries[i], "image_path": str(paths[i])}, one[i]
            elif form == 1:
                payload, want = {"query": queries[i], "image_b64": b64[i]}, one[i]
            elif form == 2:
                ids = [stable[(c + r + k) % len(stable)] for k in range(3)]
                payload = {"requests": [{"query": queries[j], "image_path": str(paths[j])} for j in ids]}
                want = [one[j] for j in ids]
            else:
                payload = {"queries": [queries[j] for j in stable[:3]], "image_path": str(paths[i])}
                want = mq_want[i]
            code, body, _, _ = _post(url, payload)
            out.append((form, code, body, want))
        return out

    srv, url = _serve(f32, window_ms=5.0)
    try:
        with ThreadPoolExecutor(32) as ex:
            answers = [a for res in ex.map(client, range(32)) for a in res]
        with urllib.request.urlopen(url + "/statz", timeout=30) as r:
            statz = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    for form, code, body, want in answers:
        if code != 200:
            raise AssertionError(f"daemon form {form}: status {code}, {body}")
        got = body["results"] if form >= 2 else [body]
        _held_results(f"daemon form {form} vs Grounder.ground", got, want if isinstance(want, list) else [want])
    if not statz["mean_batch_fill"] > 1 or statz["errors"]:
        raise AssertionError(f"daemon /statz {statz}")
    log(f"serving: daemon answered {len(answers)} requests from 32 clients (path, b64, requests list, queries), "
        f"all 200 and equal to Grounder.ground (float32); {len(stable)}/{BATCH} inputs in the pool; /statz {statz}")

    srv, url = _serve(f32, window_ms=5.0, max_queue=4)
    try:
        burst = {"requests": [{"query": queries[i], "image_path": str(paths[i])} for i in stable[:3]]}
        with ThreadPoolExecutor(16) as ex:
            shed = list(ex.map(lambda _: _post(url, burst), range(16)))
    finally:
        srv.shutdown()
        srv.server_close()
    codes = [c for c, *_ in shed]
    if set(codes) - {200, 503} or 503 not in codes or any(
            h.get("Retry-After") != "1" for c, _, h, _ in shed if c == 503):
        raise AssertionError(f"max_queue=4 under a burst of 16: statuses {codes}")
    log(f"serving: max_queue=4 under a burst of 16 three-pair requests: {codes.count(200)} answered, "
        f"{codes.count(503)} shed with 503 and Retry-After: 1")
    del f32, f32_full

    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"the serving paths launched (K1, K2, K3) {launches} times")

    # Timings, bf16.
    torch.cuda.synchronize()
    per_bucket = {n: _median_ms(lambda n=n: g.ground(paths[:n], queries[:n])) for n in (1, 2, 4, 8, BATCH)}
    full_one = _median_ms(lambda: g_full.ground(paths[:1], queries[:1]))
    t_mq = _median_ms(lambda: g.ground_image(img, mq))
    t_tiled = _median_ms(lambda: g.ground([img] * 5, mq))
    log(f"serving timings on {smi} (bf16, B={BATCH}, median of 5, host clock, PNG decode included): ground per bucket "
        + ", ".join(f"{n}: {t:.3f} ms" for n, t in per_bucket.items())
        + f"; 1 request padded to {BATCH} (bucket_sizes=({BATCH},)): {full_one:.3f} ms; ground_image of 5 "
        f"queries {t_mq:.3f} ms vs ground of 5 tiled {t_tiled:.3f} ms ({t_mq / t_tiled:.2f}x)")
    for n in (1, BATCH):
        kern = device_kernels(lambda n=n: g.ground(paths[:n], queries[:n]), 3)
        busy = sum(t for _, t, _ in kern)
        prep = _median_ms(lambda n=n: prep_chunk(g.cfg, g.vocab, g._pad_to(n), paths[:n], queries[:n]))
        log(f"serving breakdown on {smi}, ground of {n} request(s): device {busy:.3f} ms in "
            f"{sum(c for *_, c in kern):.0f} kernel launches, host PNG decode and padding {prep:.3f} ms, "
            f"wall {per_bucket[n]:.3f} ms (device idle {1 - busy / per_bucket[n]:.1%})")
    srv, url = _serve(g, window_ms=5.0)
    try:
        seen = {"requests": 0, "batches": 0}
        for clients, per in ((16, 8), (64, 4)):
            def run(c: int, per=per) -> list[float]:
                lat = []
                for r in range(per):
                    i = (c * per + r) % len(paths)
                    code, _, _, dt = _post(url, {"query": queries[i], "image_path": str(paths[i])})
                    if code != 200:
                        raise AssertionError(f"daemon timing request: status {code}")
                    lat.append(dt * 1e3)
                return lat

            t0 = time.perf_counter()
            with ThreadPoolExecutor(clients) as ex:
                lat = sorted(x for res in ex.map(run, range(clients)) for x in res)
            wall = time.perf_counter() - t0
            with urllib.request.urlopen(url + "/statz", timeout=30) as r:
                statz = json.loads(r.read())
            fill = (statz["requests"] - seen["requests"]) / (statz["batches"] - seen["batches"])
            seen = statz
            log(f"serving daemon on {smi} (bf16, batch {BATCH}, window 5 ms, image_path form): {clients} clients x {per} "
                f"requests: {len(lat) / wall:.1f} pairs/s, p50 {lat[len(lat) // 2]:.3f} ms, p95 "
                f"{lat[int(len(lat) * 0.95)]:.3f} ms, max {lat[-1]:.3f} ms; mean batch fill {fill:.2f}")
    finally:
        srv.shutdown()
        srv.server_close()
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"the serving paths launched (K1, K2, K3) {launches} times")
    log(f"serving phase passed in {time.perf_counter() - t_phase:.1f} s; K1, K2, K3 launches in it {launches}")
    return launches


# (B, H, W, Cin, Cmid, Cout, projection, x dtype, kernel): the main path's two
# blocks, layer1 widths with ragged tiles on both axes (and B = 1, and sides
# under a tile), float32 x at layer1 width, and two odd small shapes.
K3_SHAPES = {
    "identity": (BATCH, 75, 75, 256, 64, 256, False, "bfloat16", "wgmma8x16"),
    "projection": (BATCH, 75, 75, 64, 64, 256, True, "bfloat16", "wgmma8x16"),
    "ragged identity": (1, 13, 21, 256, 64, 256, False, "bfloat16", "wgmma8x16"),
    "ragged projection": (2, 9, 17, 64, 64, 256, True, "bfloat16", "wgmma8x16"),
    "small identity": (1, 5, 3, 256, 64, 256, False, "bfloat16", "wgmma8x16"),
    "float32 identity": (2, 19, 23, 256, 64, 256, False, "float32", "wgmma8x16"),
    "float32 projection": (2, 19, 23, 64, 64, 256, True, "float32", "wgmma8x16"),
    "odd identity": (3, 11, 9, 16, 8, 16, False, "bfloat16", "mma"),
    "odd projection": (3, 11, 9, 16, 8, 32, True, "bfloat16", "mma"),
}


def check_bottleneck_kernel() -> float:
    """Phase 7a: K3 against its plain version at layer1's identity and
    projection blocks, at layer1 widths with ragged tiles, in float32, and
    at odd small shapes (atol/rtol 2e-2, the JAX test's), bit-identical on
    repeat; each shape must go to the kernel its widths select, and at
    layer1 widths the two kernels of the source must agree with each other
    within the same tolerance. Returns the identity block's max abs error."""
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import (
        bottleneck_infer_reference, fused_bottleneck_infer, kernel_for, launch_variant,
    )
    from zsgnet_tpu_torch.tools.bench_bottleneck import random_args

    errors = {}
    for i, (name, (b, h, w, cin, cmid, cout, proj, dtype, kernel)) in enumerate(K3_SHAPES.items()):
        rng = np.random.default_rng(SEED + 10 + i)
        x = torch.from_numpy(rng.normal(size=(b, h, w, cin)).astype(np.float32)).cuda().to(getattr(torch, dtype))
        args = random_args(rng, cin, cmid, cout, proj, "cuda")
        took = kernel_for(cin, cmid, cout, proj)
        if took != kernel:
            raise AssertionError(f"K3 {name}: widths {cin}, {cmid}, {cout} select kernel {took}, expected {kernel}")
        got = fused_bottleneck_infer(x, **args)
        again = fused_bottleneck_infer(x, **args)
        want = bottleneck_infer_reference(x, **args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K3 {name}: two calls on the same input differ")
        errors[name] = float((got.float() - want.float()).abs().max())
        if got.dtype != x.dtype or not torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2):
            raise AssertionError(f"K3 {name} {list(x.shape)} -> {cout}: max abs error {errors[name]} "
                                 "against its plain version (atol/rtol 2e-2)")
        if kernel != "mma":
            for other in ("mma", "wgmma8x8"):
                alt = launch_variant(other, x, **args)
                if not torch.allclose(alt.float(), got.float(), atol=2e-2, rtol=2e-2):
                    raise AssertionError(f"K3 {name}: the {other} kernel and the {kernel} kernel disagree by "
                                         f"{float((alt.float() - got.float()).abs().max())}")
        log(f"K3 {name} {list(x.shape)} {dtype} -> {cout}: kernel {took}, max abs error {errors[name]}")
    log("K3 vs plain (atol/rtol 2e-2, bit-identical on repeat, kernels agree at layer1 widths): passed "
        f"{len(errors)} shapes")
    return errors["identity"]


def check_layer1() -> tuple[int, int]:
    """Phase 7b, this slice's path: layer1 of the full-width model (BatchNorm
    statistics drawn from U(0.6, 1.4)) through ``block_args`` and three K3
    launches, against the eager layer1 in eval mode under bf16 autocast, on
    the stem's output of a synthetic batch, twice: the first pass also packs
    each block's weights for the Hopper kernel (one packing launch a block),
    the second finds them packed. Returns K3's launches in the second pass
    and the packing launches of the first."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.models.zsgnet import get_default_net
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import block_args, fused_bottleneck_infer

    model = get_default_net(get_default_cfg(), seed=SEED, device="cuda")
    enc = model.backbone.encoder
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in (enc.bn1, *(m for m in enc.layer1.modules() if isinstance(m, torch.nn.BatchNorm2d))):
            for buf in (m.running_mean, m.running_var):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.8 + 0.6)
    img = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, size=(BATCH, 300, 300, 3)).astype(np.uint8)).cuda()
    with torch.inference_mode():
        x = (img.permute(0, 3, 1, 2).float() / 255.0 - model.img_mean) / model.img_std
        with torch.autocast("cuda", dtype=torch.bfloat16):
            stem = enc.maxpool(enc.relu(enc.bn1(enc.conv1(x))))
            want = enc.layer1(stem).permute(0, 2, 3, 1)
        args = [block_args(block) for block in enc.layer1]
        h = stem.permute(0, 2, 3, 1).contiguous()
        h0 = h
        for attempt in range(2):
            fused_bottleneck_infer.launches = fused_bottleneck_infer.pack_launches = 0
            h = h0
            for a in args:
                h = fused_bottleneck_infer(h, **a)
            torch.cuda.synchronize()
            if attempt == 0:
                pack_launches = fused_bottleneck_infer.pack_launches
        launches, repacked = fused_bottleneck_infer.launches, fused_bottleneck_infer.pack_launches
    diff = float((h.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    log(f"layer1 {list(stem.shape)} NCHW -> {list(h.shape)} NHWC through {launches} K3 launches "
        f"({pack_launches} weight-packing launches on first sight, {repacked} after) vs "
        f"the eager layer1 (bf16 autocast): max abs diff {diff:.4f}, scale {scale:.4f}, "
        f"relative {diff / max(scale, 1e-6):.5f}")
    if h.dtype != torch.bfloat16 or tuple(h.shape) != (BATCH, 75, 75, 256) or not torch.isfinite(h).all():
        raise AssertionError(f"layer1 through K3 gave {h.dtype} {tuple(h.shape)}")
    if not diff / max(scale, 1e-6) < 0.05:
        raise AssertionError(f"layer1 through K3 differs from the eager layer1 by {diff} of {scale}")
    if launches != 3:
        raise AssertionError(f"layer1 launched K3 {launches} times, expected 3")
    if (pack_launches, repacked) != (3, 0):
        raise AssertionError(f"layer1 packed weights {pack_launches} times in its first pass and {repacked} "
                             "in its second, expected 3 and 0")
    return launches, pack_launches


def bottleneck_timings() -> dict:
    """Phase 7c: the bench entry at B = 16 (identity and projection) and once
    at its default B = 128 (identity)."""
    from zsgnet_tpu_torch.tools.bench_bottleneck import bench

    runs = {"identity": bench(BATCH), "projection": bench(BATCH, proj=True), "identity B=128": bench()}
    for name, r in runs.items():
        bytes_ms = r["bytes"] / H100_BYTES_PER_S * 1e3
        ops_ms = r["flops"] / H100_BF16_OPS_PER_S * 1e3
        r["bound_ms"], r["bound_by"] = max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"K3 {name} {r['shape']} -> {r['cout']}: kernel {r['k3_kernel']}, on the card "
            f"{r['k3_device_ms']:.4f} ms per launch, {r['k3_ms']:.4f} ms per call back to back "
            f"({'chained' if r['chained'] else 'repeated'}); side by side on the card: mma.sync "
            f"{r['k3_mma_device_ms']:.4f} ms, wgmma 8x8 {r['k3_wgmma8x8_device_ms']:.4f} ms, wgmma 8x16 "
            f"{r['k3_wgmma8x16_device_ms']:.4f} ms (mma.sync / selected "
            f"{r['k3_mma_device_ms'] / r['k3_device_ms']:.2f}x); back to back: mma.sync {r['k3_mma_ms']:.4f} ms, "
            f"wgmma 8x8 {r['k3_wgmma8x8_ms']:.4f} ms, wgmma 8x16 {r['k3_wgmma8x16_ms']:.4f} ms; weight "
            f"prologue alone {r['prologue_device_ms']:.4f} ms on the card; plain {r['plain_ms']:.4f} ms, eager "
            f"cuDNN NCHW {r['eager_nchw_ms']:.4f} ms, channels_last {r['eager_channels_last_ms']:.4f} ms; "
            f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} ({r['bytes'] / 1e6:.2f} MB, "
            f"{r['flops'] / 1e9:.2f} GFLOP), {r['bound_ms'] / r['k3_device_ms']:.1%} of it reached; "
            f"rel diff {r['rel_diff']:.5f}, eager {r['eager_rel_diff']:.5f}")
        if not r["k3_device_ms"] < r["k3_mma_device_ms"]:
            raise AssertionError(f"K3 {name}: the selected kernel ({r['k3_device_ms']} ms on the card) is not "
                                 f"faster than the mma.sync kernel ({r['k3_mma_device_ms']} ms) in the same run")
    return runs


def check_bottleneck() -> dict:
    """Phase 7: K3 against its plain version, the full-width layer1 through
    it, and its timings; returns its entry of the kernels line."""
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer
    from zsgnet_tpu_torch.tools.bench_bottleneck import random_args

    err = check_bottleneck_kernel()
    launches, pack_launches = check_layer1()
    runs = bottleneck_timings()
    b, h, w, cin, cmid, cout, proj = K3_SHAPES["identity"][:7]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(b, h, w, cin)).astype(np.float32)).cuda().bfloat16()
    args = random_args(rng, cin, cmid, cout, proj, "cuda")
    kernels = device_kernels(lambda: fused_bottleneck_infer(x, **args), 20)
    # Per launch of its one kernel: the profiler may record fewer launches than were made.
    device_ms = sum(t / n for _, t, n in kernels)
    if len(kernels) != 1:
        raise AssertionError(f"K3 must be one kernel per call once its weights are packed: {kernels}")
    log(f"K3 identity device time {device_ms:.4f} ms per launch "
        f"({[(k[:60], round(t, 5), n) for k, t, n in kernels]}: name, ms and launches per call)")
    r = runs["identity"]
    route = min(("eager_nchw_ms", "eager_channels_last_ms"), key=lambda k: r[k])
    return {
        "name": "fused_bottleneck_infer",
        "route": "cuda",
        "source": "zsgnet_tpu_torch/csrc/fused_bottleneck.cu",
        "replaces": "zsgnet_tpu/ops/pallas/fused_bottleneck.py:53",
        "launches": launches,
        "max_abs_err": err,
        "ms": r["k3_ms"],
        "device_ms": device_ms,
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r[route],
        "library_route": {"eager_nchw_ms": "eager Bottleneck, cuDNN, bf16 autocast, NCHW",
                          "eager_channels_last_ms": "eager Bottleneck, cuDNN, bf16 autocast, channels_last"}[route],
        "kernel": r["k3_kernel"],
        "k3_mma_ms": r["k3_mma_ms"],
        "k3_mma_device_ms": r["k3_mma_device_ms"],
        "k3_wgmma8x8_device_ms": r["k3_wgmma8x8_device_ms"],
        "k3_wgmma8x16_device_ms": r["k3_wgmma8x16_device_ms"],
        "prologue_device_ms": r["prologue_device_ms"],
        "pack_launches": pack_launches,
    }


# ------------------------------------------------------------ phase 9

GROUP_IMAGES, GROUP_Q = 24, 5  # configs/flickr30k_grouped.json: 120 pairs a step
SSD_ANCHORS = 17460  # (38² + 19² + 10² + 5² + 3² + 1²) · 9 at 300²
CUDA = torch.device("cuda")


def _bound(n_bytes: int, ops: int) -> tuple[float, str]:
    """The least time for ``n_bytes`` at the card's memory rate and ``ops``
    float32 operations at its peak, and which of the two bounds it."""
    bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _counts() -> tuple[int, int]:
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward

    return fused_match_loss.launches, fused_match_loss_backward.launches


def _zero_counts() -> None:
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward

    fused_match_loss.launches = fused_match_loss_backward.launches = 0


def hold_loss_kernels(name: str, cfg, out: dict, annot: torch.Tensor, w: torch.Tensor,
                      anchors: np.ndarray) -> tuple[float, float]:
    """K1 and K2 on a model's real outputs against their plain versions on
    the same inputs (K1: num_pos exact, sums rtol 1e-4; K2: atol 1e-6) and
    the fused loss against the eager ``losses.zsg_loss`` (rtol 1e-4). These
    launches count nothing. Returns K1's and K2's max abs errors."""
    from zsgnet_tpu_torch.ops import anchors as anchor_ops, losses
    from zsgnet_tpu_torch.ops.cuda import fused_loss as fl

    dev = CUDA
    att, bbx = out["att_out"].float().contiguous(), out["bbx_out"].float().contiguous()
    anc = fl.pack_anchors(anchors, dev)
    hp = (cfg.matching_threshold, cfg.neg_threshold, cfg.focal_alpha, cfg.focal_gamma)
    got, best = fl._launch_fwd(att, bbx, *anc, annot, w, *hp)
    want = fl.fused_match_loss_reference(att, bbx, *anc, annot, w, *hp)
    if float(got[2]) != float(want[2]) or not torch.allclose(got[:2], want[:2], rtol=1e-4, atol=0.0):
        raise AssertionError(f"{name}: K1 {got.tolist()} != plain {want.tolist()} (rtol 1e-4)")
    n = got[2].clamp(min=1.0)
    grad = torch.stack([1.0 / n, cfg.lamb_reg / n, torch.zeros_like(n)])
    err2 = _held(f"{name} K2", fl.launch_bwd_variant(fl.BWD_KERNEL, att, bbx, *anc, annot, w, best, grad, *hp),
                 fl.fused_match_loss_backward_reference(att, bbx, *anc, annot, w, grad, *hp), 1e-6)
    labels, reg_t = anchor_ops.match_and_encode(torch.as_tensor(anchors, device=dev), annot,
                                                cfg.matching_threshold, cfg.neg_threshold)
    eager = losses.zsg_loss(att, bbx, labels, reg_t, lamb_reg=cfg.lamb_reg, alpha=cfg.focal_alpha,
                            gamma=cfg.focal_gamma, sample_weight=w)["total"]
    fused = got[0] / n + cfg.lamb_reg * got[1] / n
    if not torch.allclose(fused, eager, rtol=1e-4):
        raise AssertionError(f"{name}: fused loss {float(fused)} != eager {float(eager)}")
    err1 = float((got.double() - want.double()).abs().max())
    log(f"{name}: K1 at B={att.shape[0]} A={att.shape[1]} on the model's outputs {got.tolist()} == plain "
        f"(max abs err {err1:.3g}, {int(float(got[2]))} weighted positives, {int((w == 0).sum())} rows of "
        f"weight 0); K2 within {err2:.3g} of plain; loss {float(fused):.6f} == eager {float(eager):.6f}")
    return err1, err2


def variant_loss_timings(r: dict, which: str) -> dict:
    """K1's or K2's (``which``) numbers from a ``tools/bench_loss.py`` run
    ``r`` at a variant's shape, with its bound at those inputs."""
    b, a = r["shape"]
    if which == "k1":
        bound_ms, by = _bound(r["k1_bytes"], b * a * K1_OPS_PER_ELEMENT)
    else:
        bound_ms, by = _bound(r["k2_bytes"], b * a * K2_OPS_PER_ELEMENT + r["positives"] * K2_OPS_PER_POSITIVE)
    return {"shape": r["shape"], "ms": r[f"{which}_ms"], "device_ms": r[f"{which}_device_ms"],
            "plain_ms": r[f"{which}_plain_ms"], "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / r[f"{which}_device_ms"]}


def _step_ms(step, state, batch, runs: int) -> tuple[list[float], int]:
    """Host ms of ``runs`` train steps that each end in a synchronize, and
    the peak memory allocated over them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        _, ls = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(ls["total"]):
            raise AssertionError("non-finite training loss while timing")
    return times, torch.cuda.max_memory_allocated()


def check_grouped(tmp: Path) -> tuple[tuple[int, int], tuple[float, float]]:
    """Phase 9a: grouped multi-query training to configs/flickr30k_grouped.json
    (retina, 300², bf16, 24 images × 5 phrases) through ``main_dist`` on
    all-objects synthetic data (2–4 phrases an image, so every unit wraps),
    then K1/K2 on the grouped outputs, grouped float32 validation against
    flat, and the grouped step against a flat step of the same 120 pairs,
    in turns. Returns the (K1, K2) launches of the ``main_dist`` run and
    their max abs errors on the outputs."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.data.synthetic import generate
    from zsgnet_tpu_torch.main import main_dist
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for
    from zsgnet_tpu_torch.parallel.train_step import make_train_step, pairs_and_weights, to_device
    from zsgnet_tpu_torch.train.learner import Learner

    t_phase = time.perf_counter()
    preset = Path(__file__).resolve().parent / "configs" / "flickr30k_grouped.json"
    data_dir = tmp / "grouped_data"
    generate(data_dir, n_train=3 * GROUP_IMAGES, n_val=GROUP_IMAGES, n_test=2, img_size=300,
             seed=SEED, all_objects=True)
    run_dir = tmp / "grouped_run"
    kw = dict(ds_to_use="synthetic", data_dir=str(data_dir), tmp_path=str(run_dir), epochs=1,
              seed=SEED, log_every=1)
    cfg = get_default_cfg(preset).replace(uid="grouped", **kw)
    if (cfg.bs, cfg.queries_per_img, cfg.compute_dtype, cfg.mdl_to_use) != (
            GROUP_IMAGES, GROUP_Q, "bfloat16", "retina"):
        raise AssertionError(f"the grouped preset changed: {cfg}")
    data = get_data(cfg)
    n_steps, n_val = len(data.train_dl), len(data.valid_dl)
    _zero_counts()
    t0 = time.perf_counter()
    metrics = main_dist("grouped", device=CUDA, cfg_file=str(preset), **kw)
    torch.cuda.synchronize()
    launches = _counts()
    row = json.loads((run_dir / "logs" / "grouped.jsonl").read_text().splitlines()[-1])
    log(f"grouped main_dist ({cfg.bs} images x {cfg.queries_per_img} phrases, {n_steps} steps, {n_val} val "
        f"batch(es)) in {time.perf_counter() - t0:.2f} s; K1 launches {launches[0]}, K2 {launches[1]}; "
        f"log row {row}")
    if launches != (n_steps + 2 * n_val, n_steps):
        raise AssertionError(f"grouped (K1, K2) launches {launches}, expected "
                             f"{(n_steps + 2 * n_val, n_steps)}: one per step and per val batch")
    if row["step"] != n_steps or not np.isfinite(row["train_total"]) or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"grouped run: log row {row}, metrics {metrics}")

    # K1 and K2 at B = 120 on the trained model's outputs.
    anchors = anchor_pyramid_for(cfg)
    learn = Learner("grouped", data, cfg.replace(resume=True), device=CUDA)
    vb = data.valid_dl.first_batch()
    with torch.inference_mode():
        b = to_device(vb, CUDA)
        out = learn.model.eval()(b["img"], b["qvec"], b["qlens"])
        annot, w = pairs_and_weights(b, b["valid"])
    if tuple(out["att_out"].shape) != (GROUP_IMAGES * GROUP_Q, anchors.shape[0]) or not bool((w == 0).any()):
        raise AssertionError(f"grouped outputs {tuple(out['att_out'].shape)}, pair weights {w.tolist()}")
    err = hold_loss_kernels("grouped val batch", cfg, out, annot, w, anchors)

    # Grouped validation in float32 (TF32 off) against the flat loader.
    cfg32 = cfg.replace(compute_dtype="float32", resume=True)
    lg = Learner("grouped", get_data(cfg32), cfg32, device=CUDA)
    cfg_f = cfg32.replace(uid="flat", queries_per_img=1, bs=BATCH,
                          resume_path=str(run_dir / "models" / "grouped"))
    lf = Learner("flat", get_data(cfg_f), cfg_f, device=CUDA)
    mg, mf = lg.validate(), lf.validate()
    recs = {}
    for uid in ("grouped", "flat"):
        rows = [json.loads(x) for x in (run_dir / "predictions" / f"{uid}_val.jsonl").read_text().splitlines()]
        recs[uid] = {r["id"]: r for r in rows}
        if len(recs[uid]) != len(rows):
            raise AssertionError(f"{uid} validation counted a pair twice")
    iou_diff = max(abs(recs["grouped"][i]["iou"] - recs["flat"][i]["iou"]) for i in recs["flat"])
    log(f"float32 validation, grouped {mg} vs flat {mf}; per-pair IoU max abs diff {iou_diff:.3g}")
    if (set(recs["grouped"]) != set(recs["flat"]) or mg["num_samples"] != mf["num_samples"]
            or (mg["Acc"], mg["MaxPos"]) != (mf["Acc"], mf["MaxPos"]) or iou_diff > 1e-4):
        raise AssertionError("grouped float32 validation differs from flat")
    del lg, lf

    # The grouped step against a flat step of the same 120 pairs, in turns.
    gb = data.train_dl.first_batch()
    q = GROUP_Q
    fb = {"img": np.repeat(gb["img"], q, axis=0), "qvec": gb["qvec"].reshape(-1, gb["qvec"].shape[-1]),
          "qlens": gb["qlens"].reshape(-1), "annot": gb["annot"].reshape(-1, 4)}
    steps = {"grouped": (make_train_step(cfg, anchors, CUDA), gb),
             "flat": (make_train_step(cfg.replace(queries_per_img=1, bs=GROUP_IMAGES * q), anchors, CUDA), fb)}
    state = learn.state
    res = {k: {"ms": [], "peak": 0} for k in steps}
    for step, batch in steps.values():
        _step_ms(step, state, batch, 2)  # warm-up
    for name in ("grouped", "flat", "flat", "grouped") * 2:
        times, peak = _step_ms(steps[name][0], state, steps[name][1], 2)
        res[name]["ms"] += times
        res[name]["peak"] = max(res[name]["peak"], peak)
    for name, (step, batch) in steps.items():
        kernels = device_kernels(lambda: step(state, batch), 3)
        res[name]["device_ms"] = sum(t for _, t, _ in kernels)
        res[name]["launches"] = sum(n for *_, n in kernels)
        res[name]["median"] = statistics.median(res[name]["ms"])
        log(f"{name} train step, {GROUP_IMAGES * q} pairs ({GROUP_IMAGES if name == 'grouped' else GROUP_IMAGES * q} "
            f"images) bf16 Adam: median {res[name]['median']:.3f} ms over {len(res[name]['ms'])} steps in turns "
            f"({[round(t, 2) for t in res[name]['ms']]}); device {res[name]['device_ms']:.3f} ms in "
            f"{res[name]['launches']:.0f} launches; peak memory {res[name]['peak'] / 2**30:.3f} GiB; "
            f"top {[(kk[:50], round(t, 3), n) for kk, t, n in kernels[:5]]}")
    g, f = res["grouped"], res["flat"]
    log(f"grouped / flat at 120 pairs: wall {g['median'] / f['median']:.3f}x, device "
        f"{g['device_ms'] / f['device_ms']:.3f}x, pairs/s {120e3 / g['median']:.1f} vs {120e3 / f['median']:.1f}, "
        f"peak memory {g['peak'] / f['peak']:.3f}x")
    log(f"grouped phase passed in {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def check_ssd(data_dir: str, tmp: Path) -> tuple[tuple[int, int], tuple[float, float]]:
    """Phase 9b: SSD-VGG16 at 300², B = 16, bf16, native channels (six
    per-level heads, A = 17460) through ``main_dist`` on phase 6's data,
    then K1/K2 on its outputs, its train step and eval step profiled.
    Returns the (K1, K2) launches of the run and their max abs errors on the
    outputs."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.main import main_dist
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for
    from zsgnet_tpu_torch.parallel.train_step import pairs_and_weights, to_device
    from zsgnet_tpu_torch.train.learner import Learner

    t_phase = time.perf_counter()
    kw = dict(ds_to_use="synthetic", data_dir=data_dir, tmp_path=str(tmp / "ssd_run"), epochs=1, bs=BATCH,
              seed=SEED, log_every=1, mdl_to_use="ssd_vgg")
    cfg = get_default_cfg().replace(uid="ssd", **kw)
    anchors = anchor_pyramid_for(cfg)
    if anchors.shape[0] != SSD_ANCHORS or cfg.ssd_uniform_proj:
        raise AssertionError(f"SSD pyramid has {anchors.shape[0]} anchors")
    data = get_data(cfg)
    n_steps, n_val = len(data.train_dl), len(data.valid_dl)
    _zero_counts()
    t0 = time.perf_counter()
    metrics = main_dist("ssd", device=CUDA, **kw)
    torch.cuda.synchronize()
    launches = _counts()
    log(f"ssd_vgg main_dist ({n_steps} steps, {n_val} val batches) in {time.perf_counter() - t0:.2f} s: "
        f"{metrics}; K1 launches {launches[0]}, K2 {launches[1]}")
    if launches != (n_steps + 2 * n_val, n_steps) or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"ssd (K1, K2) launches {launches}, metrics {metrics}")

    learn = Learner("ssd", data, cfg.replace(resume=True), device=CUDA)
    heads = [m.conv0.in_channels - cfg.lang_dim - 2 for m in learn.model.heads]
    if heads != [512, 1024, 512, 256, 256, 256]:
        raise AssertionError(f"SSD per-level heads see {heads} visual channels")
    vb = data.valid_dl.first_batch()
    with torch.inference_mode():
        b = to_device(vb, CUDA)
        out = learn.model.eval()(b["img"], b["qvec"], b["qlens"])
        annot, w = pairs_and_weights(b, b["valid"])
    err = hold_loss_kernels("ssd val batch", cfg, out, annot, w, anchors)

    tb = data.train_dl.first_batch()
    step = learn.train_step
    _step_ms(step, learn.state, tb, 2)
    times, peak = _step_ms(step, learn.state, tb, 8)
    kernels = device_kernels(lambda: step(learn.state, tb), 3)
    busy = sum(t for _, t, _ in kernels)
    log(f"ssd_vgg train step B={BATCH} bf16 Adam: median {statistics.median(times):.3f} ms "
        f"({[round(t, 2) for t in times]}); device {busy:.3f} ms in {sum(n for *_, n in kernels):.0f} launches; "
        f"peak memory {peak / 2**30:.3f} GiB; top {[(k[:50], round(t, 3), n) for k, t, n in kernels[:6]]}")
    ev = lambda: learn.eval_step(learn.model, vb)  # noqa: E731
    ev()
    torch.cuda.synchronize()
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        ev()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    kernels = device_kernels(ev, 3)
    log(f"ssd_vgg eval step B={BATCH} bf16: median {statistics.median(lat):.3f} ms; device "
        f"{sum(t for _, t, _ in kernels):.3f} ms in {sum(n for *_, n in kernels):.0f} launches")
    log(f"ssd phase passed in {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def check_remat(data_dir: str) -> None:
    """Phase 9c: one retina train step at B = 16 with and without
    ``remat_backbone`` from the same weights on the same batch. In float32
    the losses agree within 1e-5 relative and the BatchNorm statistics
    (running moments within 1e-6, ``num_batches_tracked`` exact); peak
    memory and step time are logged in float32 and bf16."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step

    t_phase = time.perf_counter()
    base = get_default_cfg().replace(ds_to_use="synthetic", data_dir=data_dir, bs=BATCH, seed=SEED)
    data = get_data(base)
    batch = data.train_dl.first_batch()
    anchors = anchor_pyramid_for(base)
    for dtype in ("float32", "bfloat16"):
        res = {}
        for remat in (False, True):
            cfg = base.replace(compute_dtype=dtype, remat_backbone=remat)
            model = get_default_net(cfg, len(data.vocab), seed=SEED, device=CUDA)
            state = create_train_state(cfg, model)
            step = make_train_step(cfg, anchors, CUDA)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, ls = step(state, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k or "tracked" in k}
            times, _ = _step_ms(step, state, batch, 4)
            res[remat] = (float(ls["total"]), stats, peak, statistics.median(times))
            del model, state, step
        (l0, s0, p0, t0), (l1, s1, p1, t1) = res[False], res[True]
        diff = max(float((s1[k].double() - s0[k].double()).abs().max()) for k in s0 if "running" in k)
        log(f"remat {dtype}: loss {l1:.7f} vs {l0:.7f}; BN statistics max abs diff {diff:.3g}; peak memory "
            f"{p1 / 2**30:.3f} vs {p0 / 2**30:.3f} GiB ({p1 / p0:.3f}x); step median {t1:.3f} vs {t0:.3f} ms")
        if dtype == "float32":
            if abs(l1 - l0) > 1e-5 * abs(l0) or diff > 1e-6 or any(
                    not torch.equal(s1[k], s0[k]) for k in s0 if "tracked" in k):
                raise AssertionError("remat's step differs from the step without remat")
            if int(s1["backbone.encoder.bn1.num_batches_tracked"]) != 1:
                raise AssertionError("remat updated the BatchNorm statistics twice")
        if not p1 < p0:
            raise AssertionError(f"remat did not lower the peak memory ({dtype}): {p1} vs {p0}")
    log(f"remat phase passed in {time.perf_counter() - t_phase:.1f} s")


def check_variants(data_dir: str, tmp: Path, k1: dict, k2: dict) -> None:
    """Phase 9: the model and training variants (grouped, SSD-VGG, remat),
    each path driven with the kernels' counts set to 0 just before it; K1
    and K2's launches there, their errors on the real outputs and their
    times and bounds at the new shapes go into their entries."""
    from zsgnet_tpu_torch.tools.bench_loss import bench

    t_phase = time.perf_counter()
    g_launches, g_err = check_grouped(tmp)
    s_launches, s_err = check_ssd(data_dir, tmp)
    check_remat(data_dir)
    r_grouped, r_ssd = bench(GROUP_IMAGES * GROUP_Q), bench(BATCH, mdl_to_use="ssd_vgg")
    for i, (k, which) in enumerate(((k1, "k1"), (k2, "k2"))):
        k["grouped_launches"], k["ssd_launches"] = g_launches[i], s_launches[i]
        k["variant_shapes"] = {
            "grouped_b120_a17451": {**variant_loss_timings(r_grouped, which), "max_abs_err_real_outputs": g_err[i]},
            "ssd_b16_a17460": {**variant_loss_timings(r_ssd, which), "max_abs_err_real_outputs": s_err[i]},
        }
    for name, v in k1["variant_shapes"].items():
        w = k2["variant_shapes"][name]
        log(f"K1 at {v['shape']}: device {v['device_ms']:.4f} ms ({v['ms']:.4f} back to back), plain "
            f"{v['plain_ms']:.4f} ms, bound {v['bound_ms'] * 1e3:.3f} us by {v['bound_by']} "
            f"({v['bound_share']:.1%}); K2: device {w['device_ms']:.4f} ms ({w['ms']:.4f}), plain "
            f"{w['plain_ms']:.4f} ms, bound {w['bound_ms'] * 1e3:.3f} us by {w['bound_by']} ({w['bound_share']:.1%})")
    log(f"variants phase passed in {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ phase 10

FORMATS_BATCHES = (32, 64)  # int8 against bf16
EXPORT_BUCKETS = (1, 4, BATCH)

# Loads an artifact in a process of its own, grounds the requests of a JSON
# file, times the buckets and writes what it got.
_ARTIFACT_CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch
from zsgnet_tpu_torch.export import ExportedGrounder
from zsgnet_tpu_torch.predict import load_image
job = json.load(open(sys.argv[1]))
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for name, spec in job["artifacts"].items():
    t0 = time.perf_counter()
    g = ExportedGrounder.load(spec["dir"], device="cuda")
    g.warmup(multiquery=True)
    torch.cuda.synchronize()
    res = {"load_and_warmup_s": time.perf_counter() - t0,
           "ground": g.ground(job["paths"], job["queries"]),
           "ground_image": g.ground_image(job["paths"][0], job["queries"][:5])}
    if spec.get("time"):
        arrays = [load_image(p, g.cfg.resize_img)[0] for p in job["paths"][:max(g.bucket_sizes)]]
        for n in spec["time"]:
            lat = []
            for _ in range(7):
                t0 = time.perf_counter()
                g.ground(arrays[:n], job["queries"][:n])
                lat.append((time.perf_counter() - t0) * 1e3)
            res[f"ms_b{n}"] = statistics.median(lat[2:])
    out[name] = res
json.dump(out, open(sys.argv[2], "w"))
"""


def _force_per_level(g):
    """``g`` with every bucket through the per-level head."""
    g.canvas_for = lambda pad_to: False
    return g


def _arrays(g, paths: list) -> list[np.ndarray]:
    from zsgnet_tpu_torch.predict import load_image

    return [load_image(p, g.cfg.resize_img)[0] for p in paths]


def _turns(fns: dict, runs: int = 5) -> dict:
    """Wall ms medians of each function, timed in turns a, b, b, a."""
    lat = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for k in order:
        for _ in range(runs):
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            lat[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in lat.items()}


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of matching rows of two (N, 4) tlbr arrays."""
    tl, br = np.maximum(a[:, :2], b[:, :2]), np.minimum(a[:, 2:], b[:, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], axis=1)  # noqa: E731
    return inter / np.maximum(area(a) + area(b) - inter, 1e-12)


def check_canvas(model_dir: Path, paths: list, queries: list, smi: str) -> dict:
    """Phase 10a: the canvas head against the per-level head on phase 6's
    checkpoint: raw outputs and ``ground`` in float32 (equal: the same
    convolutions over the same values, TF32 off), in bf16 (range-checked,
    differences logged), then launches per ``ground`` call and wall time at
    buckets 1 and 16, in turns, on pre-decoded images."""
    from zsgnet_tpu_torch.predict import Grounder, encode_queries, prep_chunk

    f32 = Grounder.from_checkpoint(model_dir, batch_size=BATCH, cfg_overrides={"compute_dtype": "float32"},
                                   device="cuda")
    if not f32.cfg.head_canvas:
        raise AssertionError("a batch-16 Grounder does not serve through the canvas head")
    f32_pl = _force_per_level(Grounder(f32.cfg, f32.vocab, f32.model.state_dict(), batch_size=BATCH, device="cuda"))
    for n in (1, BATCH):
        img, qvec, qlens, _, _ = prep_chunk(f32.cfg, f32.vocab, n, paths[:n], queries[:n])
        with torch.inference_mode():
            args = (torch.from_numpy(img).cuda(), torch.from_numpy(qvec).cuda(), torch.from_numpy(qlens))
            a, b = f32.model(*args, canvas=True), f32.model(*args, canvas=False)
        d_att = float((a["att_out"] - b["att_out"]).abs().max())
        d_bbx = float((a["bbx_out"] - b["bbx_out"]).abs().max())
        scale = float(b["att_out"].abs().max())
        if d_att > 1e-4 * max(scale, 1.0) or d_bbx > 1e-4:
            raise AssertionError(f"float32 canvas vs per-level at batch {n}: att {d_att:.3g}, bbx {d_bbx:.3g}")
        anchors = (a["att_out"].argmax(-1)[:n].tolist(), b["att_out"].argmax(-1)[:n].tolist())
        err = _held_results(f"float32 canvas vs per-level ground, {n} request(s)", f32.ground(paths[:n], queries[:n]),
                            f32_pl.ground(paths[:n], queries[:n]), anchors)
        log(f"formats: float32 canvas vs per-level head, batch {n}: att max diff {d_att:.3g} (scale {scale:.3g}), "
            f"bbx {d_bbx:.3g}; ground max score diff {err:.2e}, {sum(x == y for x, y in zip(*anchors))}/{n} same anchor")
    qv, ql = encode_queries(f32.cfg, f32.vocab, 8, queries[:5])
    with torch.inference_mode():
        img1 = torch.from_numpy(_arrays(f32, paths[:1])[0][None].copy()).cuda()
        a = f32.model(img1, torch.from_numpy(qv).cuda(), torch.from_numpy(ql), canvas=True)
        b = f32.model(img1, torch.from_numpy(qv).cuda(), torch.from_numpy(ql), canvas=False)
    d_mq = float((a["att_out"] - b["att_out"]).abs().max())
    if d_mq > 1e-4 * max(float(b["att_out"].abs().max()), 1.0):
        raise AssertionError(f"float32 canvas vs per-level, one image against 5 queries: {d_mq}")
    _held_results("float32 canvas vs per-level ground_image", f32.ground_image(paths[0], queries[:5]),
                  f32_pl.ground_image(paths[0], queries[:5]))
    del f32, f32_pl

    g = Grounder.from_checkpoint(model_dir, batch_size=BATCH, device="cuda")
    g_pl = _force_per_level(Grounder(g.cfg, g.vocab, g.model.state_dict(), batch_size=BATCH, device="cuda"))
    got, want = g.ground(paths[:BATCH], queries[:BATCH]), g_pl.ground(paths[:BATCH], queries[:BATCH])
    _in_range("bf16 canvas", got)
    bf_score = max(abs(x["score"] - y["score"]) for x, y in zip(got, want))
    bf_box = max(float(np.abs(np.subtract(x["box_norm"], y["box_norm"])).max()) for x, y in zip(got, want))
    log(f"formats: bf16 canvas vs per-level ground of {BATCH}: max score diff {bf_score:.2e}, max box diff {bf_box:.2e}")

    arrays = _arrays(g, paths[:BATCH])
    numbers = {}
    for n in (1, BATCH):
        fns = {"canvas": lambda n=n: g.ground(arrays[:n], queries[:n]),
               "per_level": lambda n=n: g_pl.ground(arrays[:n], queries[:n])}
        for f in fns.values():
            f()
        wall = _turns(fns)
        for head, fn in fns.items():
            kern = device_kernels(fn, 3)
            numbers[f"{head}_b{n}"] = {"wall_ms": wall[head], "device_ms": sum(t for _, t, _ in kern),
                                       "launches": sum(c for *_, c in kern)}
        c, p = numbers[f"canvas_b{n}"], numbers[f"per_level_b{n}"]
        log(f"formats timings on {smi} (bf16, bucket {n}, pre-decoded images, medians of 10 in turns c,p,p,c): canvas "
            f"{c['wall_ms']:.3f} ms wall, {c['device_ms']:.3f} ms device in {c['launches']:.0f} launches; per-level "
            f"{p['wall_ms']:.3f} ms wall, {p['device_ms']:.3f} ms device in {p['launches']:.0f} launches")
    return numbers


def check_int8(model_dir: Path, paths: list, queries: list, smi: str) -> dict:
    """Phase 10b: int8 serving on phase 6's checkpoint. A batch-64 Grounder
    with ``quantize=True`` calibrates on its first batch (bucket 32); the
    ``torch._int_mm`` product is held against its plain version (int32
    equal) on the im2col of five convolutions as the model quantizes them,
    at batch 32 and at batch 1 (the padded shapes: the stem's K = 147, the
    head's N = 45, M = 9 at the 3×3 level); then int8 against bf16: device
    and wall ms per batch at B = 32 and 64 in turns, and the share of
    requests whose int8 box has IoU ≥ 0.5 with the bf16 box."""
    from zsgnet_tpu_torch.models import quant
    from zsgnet_tpu_torch.predict import Grounder, prep_chunk

    g8 = Grounder.from_checkpoint(model_dir, batch_size=64, bucket_sizes=(32,), quantize=True, device="cuda")
    gb = Grounder.from_checkpoint(model_dir, batch_size=64, bucket_sizes=(32,), device="cuda")
    if not g8.quantize or g8.cfg.head_canvas or gb.latency_canvas:
        raise AssertionError(f"batch-64 Grounders: quantize {g8.quantize}, canvas {g8.cfg.head_canvas}")
    t0 = time.perf_counter()
    res8 = g8.ground(paths, queries)
    torch.cuda.synchronize()
    n_scales = len(quant.quant_scales(g8.model))
    log(f"formats: int8 Grounder calibrated on its first batch (bucket 32, calib@0.999) and grounded {len(paths)} "
        f"requests in {time.perf_counter() - t0:.2f} s; {n_scales} activation scales")
    resb = gb.ground(paths, queries)
    _in_range("int8 ground", res8)
    iou = _iou(np.array([r["box_norm"] for r in res8]), np.array([r["box_norm"] for r in resb]))
    share = float((iou >= 0.5).mean())
    log(f"formats: int8 vs bf16 on {len(paths)} requests: IoU >= 0.5 for {share:.1%}, median IoU "
        f"{float(np.median(iou)):.4f}, max score diff {max(abs(a['score'] - b['score']) for a, b in zip(res8, resb)):.3g}")

    m = g8.model
    convs = {"stem": m.backbone["encoder"].conv1, "layer1.0.conv2": m.backbone["encoder"].layer1[0].conv2,
             "layer4.2.conv3": m.backbone["encoder"].layer4[2].conv3, "fpn.conv6": m.backbone["fpn"].conv6,
             "head.out": m.head.out}
    seen: dict = {}
    hooks = [c.register_forward_pre_hook(lambda mod, args, name=name: seen.setdefault(name, []).append(args[0]))
             for name, c in convs.items()]
    try:
        for n in (32, 1):
            img, qvec, qlens, _, _ = prep_chunk(g8.cfg, g8.vocab, n, paths[:n], queries[:n])
            g8._infer(torch.from_numpy(img).cuda(), torch.from_numpy(qvec).cuda(), torch.from_numpy(qlens))
    finally:
        for h in hooks:
            h.remove()
    held = {}
    for name, conv in convs.items():
        for x in seen[name]:
            xq = quant.quantize_sym(x.float(), quant.act_scale(conv.absmax("act", x)))
            wq = quant.quantize_sym(conv.weight.float(), quant.weight_scale(conv.weight)[:, None, None, None])
            cols, _, _ = quant.im2col_int8(xq, wq.shape[2:], conv.stride, conv.padding, conv.dilation)
            b = wq.reshape(wq.shape[0], -1).t()
            got, want = quant.int8_matmul(cols, b), quant.int8_matmul_reference(cols, b)
            if got.dtype != torch.int32 or not torch.equal(got, want):
                raise AssertionError(f"int8 {name} {tuple(cols.shape)}x{tuple(b.shape)}: _int_mm differs from plain "
                                     f"by {int((got.long() - want.long()).abs().max())}")
            key = f"{name} M{cols.shape[0]} K{cols.shape[1]} N{b.shape[1]}"
            held[key] = {"ms": _event_ms(lambda: quant.int8_matmul(cols, b)),
                         "plain_ms": _event_ms(lambda: quant.int8_matmul_reference(cols, b))}
    log("formats: torch._int_mm == plain int32 sums on " + "; ".join(
        f"{k} ({v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms)" for k, v in held.items()))

    numbers = {"iou_ge_0.5_share": share, "requests": len(paths), "int_mm": held}
    rng = np.random.default_rng(SEED)
    for b in FORMATS_BATCHES:
        img = torch.from_numpy(rng.integers(0, 256, (b, *g8.cfg.resize_img, 3)).astype(np.uint8)).cuda()
        qvec = torch.from_numpy(rng.integers(1, len(g8.vocab), (b, g8.cfg.max_qlen)).astype(np.int32)).cuda()
        qlens = torch.from_numpy(rng.integers(1, 8, (b,)).astype(np.int32))
        fns = {"bf16": lambda: gb._infer(img, qvec, qlens), "int8": lambda: g8._infer(img, qvec, qlens)}
        for f in fns.values():
            f()
        wall = _turns(fns)
        for fmt, fn in fns.items():
            kern = device_kernels(fn, 2)
            numbers[f"{fmt}_b{b}"] = {"wall_ms": wall[fmt], "device_ms": sum(t for _, t, _ in kern),
                                      "launches": sum(c for *_, c in kern)}
            if fmt == "int8":
                top = [(k[:50], round(t, 3)) for k, t, _ in kern[:5]]
        i8, bf = numbers[f"int8_b{b}"], numbers[f"bf16_b{b}"]
        log(f"formats timings on {smi}, batch {b} (device tensors, medians of 10 in turns): bf16 {bf['wall_ms']:.3f} ms "
            f"wall, {bf['device_ms']:.3f} ms device in {bf['launches']:.0f} launches; int8 {i8['wall_ms']:.3f} ms wall, "
            f"{i8['device_ms']:.3f} ms device in {i8['launches']:.0f} launches; int8 top kernels {top}")
    return numbers


def _event_ms(fn, iters: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_bf16_program(path: Path) -> None:
    """Every convolution of an exported bf16 program runs in bf16: autocast
    survived into the graph (as ``wrap_with_autocast`` regions, whose
    subgraphs hold the convolutions)."""
    ep = torch.export.load(path)
    convs = [nd for m in ep.graph_module.modules() if isinstance(m, torch.fx.GraphModule)
             for nd in m.graph.nodes if nd.op == "call_function" and "conv" in str(nd.target)]
    n_bf16 = sum(getattr(nd.meta.get("val"), "dtype", None) == torch.bfloat16 for nd in convs)
    if not convs or n_bf16 != len(convs):
        raise AssertionError(f"bf16 artifact: {n_bf16} of {len(convs)} convolutions in bf16")
    log(f"formats: the bf16 program's graph holds {len(convs)} convolutions "
        f"({sorted({str(nd.target) for nd in convs})}), all bf16")


def check_export(model_dir: Path, paths: list, queries: list, tmp: Path, smi: str) -> dict:
    """Phase 10c: ``export_serving`` for ``cuda`` on phase 6's checkpoint —
    a float32 version 3 artifact with buckets 1, 4 and 16 and multi-query
    programs, and a bf16 version 1 at batch 1 whose convolutions must stay
    bf16 in the graph — then the artifacts loaded in a process of their
    own and held against the live Grounders (float32 to 1e-4, bf16
    range-checked), the float32 artifact's ms per request at buckets 1 and
    16 beside the live Grounder's, and the daemon serving it. (int8 export
    round-trips in ``tests/test_torch_export.py``.)"""
    from zsgnet_tpu_torch.export import ExportedGrounder, export_serving
    from zsgnet_tpu_torch.predict import Grounder

    f32 = Grounder.from_checkpoint(model_dir, batch_size=BATCH, bucket_sizes=EXPORT_BUCKETS[:-1],
                                   cfg_overrides={"compute_dtype": "float32"}, device="cuda")
    bf = Grounder.from_checkpoint(model_dir, batch_size=1, device="cuda")
    arts = {}
    for name, g, kw in (("f32_v3", f32, dict(bucket_sizes=EXPORT_BUCKETS[:-1], weights_as_args=True, multiquery=True)),
                        ("bf16_v1", bf, {})):
        t0 = time.perf_counter()
        path = export_serving(g, tmp / name, platforms=("cuda",), **kw)
        n = len(list(path.glob("*/*.pt2")))
        size = sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
        arts[name] = {"dir": str(path)}
        log(f"formats: exported {name} ({n} programs, {size / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s")
    arts["f32_v3"]["time"] = [1, BATCH]
    check_bf16_program(Path(arts["bf16_v1"]["dir"]) / "cuda" / "serving_fn.pt2")

    job = tmp / "job.json"
    job.write_text(json.dumps({"artifacts": arts, "paths": [str(p) for p in paths[:BATCH]],
                               "queries": queries[:BATCH]}))
    live = {"f32_v3": f32, "bf16_v1": bf}
    want = {k: (g.ground(paths[:BATCH], queries[:BATCH]), g.ground_image(paths[0], queries[:5])) for k, g in live.items()}
    arrays = _arrays(f32, paths[:BATCH])
    live_ms = {n: _turns({"live": lambda n=n: f32.ground(arrays[:n], queries[:n])})["live"] for n in (1, BATCH)}
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", _ARTIFACT_CHILD, str(job), str(tmp / "got.json")], check=True, timeout=600,
                   cwd=Path(__file__).resolve().parent)
    got = json.loads((tmp / "got.json").read_text())
    log(f"formats: a fresh process loaded the two artifacts and grounded in {time.perf_counter() - t0:.1f} s")
    for name, res in got.items():
        if name == "bf16_v1":
            _in_range("bf16 artifact", res["ground"])
            err = max(abs(a["score"] - b["score"]) for a, b in zip(res["ground"], want[name][0]))
        else:
            err = _held_results(f"{name} artifact vs live ground", res["ground"], want[name][0])
            _held_results(f"{name} artifact vs live ground_image", res["ground_image"], want[name][1])
        log(f"formats: {name} artifact vs live Grounder: max score diff {err:.2e}; load + warmup "
            f"{res['load_and_warmup_s']:.1f} s")
    numbers = {"export_ms": {f"artifact_b{n}": got["f32_v3"][f"ms_b{n}"] for n in (1, BATCH)}}
    numbers["export_ms"].update({f"live_b{n}": live_ms[n] for n in (1, BATCH)})
    log(f"formats timings on {smi} (float32, pre-decoded images, medians): artifact in a fresh process bucket 1 "
        f"{numbers['export_ms']['artifact_b1']:.3f} ms, bucket {BATCH} {numbers['export_ms'][f'artifact_b{BATCH}']:.3f} ms; "
        f"live Grounder {live_ms[1]:.3f} ms, {live_ms[BATCH]:.3f} ms")

    eg = ExportedGrounder.load(arts["f32_v3"]["dir"], device="cuda")
    srv, url = _serve(eg, window_ms=5.0)
    try:
        code, body, _, _ = _post(url, {"queries": queries[:5], "image_path": str(paths[0])})
        code1, body1, _, _ = _post(url, {"query": queries[1], "image_path": str(paths[1])})
    finally:
        srv.shutdown()
        srv.server_close()
    if (code, code1) != (200, 200):
        raise AssertionError(f"daemon on the artifact: statuses {code}, {code1}")
    _held_results("daemon on the artifact, queries form", body["results"], want["f32_v3"][1])
    _held_results("daemon on the artifact, one pair", [body1], f32.ground([paths[1]], [queries[1]]))
    log("formats: the daemon on the float32 artifact answered the queries and pair forms equal to the live Grounder")
    return numbers


def check_serving_formats(model_dir: Path, data_root: Path, smi: str) -> list[int]:
    """Phase 10, serving formats, on the checkpoint phase 6 wrote: the canvas
    head, int8 and exported artifacts (``check_canvas``, ``check_int8``,
    ``check_export``). K1, K2 and K3 must not launch: returns their counts."""
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward

    kernels = (fused_match_loss, fused_match_loss_backward, fused_bottleneck_infer)
    for k in kernels:
        k.launches = 0
    t_phase = time.perf_counter()
    rows = pd.concat([pd.read_csv(data_root / "csv_dir" / f"{s}.csv") for s in ("val", "test")], ignore_index=True)
    paths = [data_root / "images" / str(p) for p in rows["img_id"]]
    queries = [str(q) for q in rows["query"]]
    numbers = check_canvas(model_dir, paths, queries, smi)
    numbers.update(check_int8(model_dir, paths, queries, smi))
    with tempfile.TemporaryDirectory() as tmp:
        numbers.update(check_export(model_dir, paths, queries, Path(tmp), smi))
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"the serving-format paths launched (K1, K2, K3) {launches} times")
    log(f"serving formats phase passed in {time.perf_counter() - t_phase:.1f} s; K1, K2, K3 launches in it "
        f"{launches}; numbers {json.dumps({k: v for k, v in numbers.items() if k != 'int_mm'})}")
    return launches


# ------------------------------------------------------------ phase 11

# What the doctor must print on the card.
DOCTOR_ROWS = ("[  ok  ] cuda device", "H100", "[  ok  ] kernels built", "[  ok  ] smoke (K1 fused loss)",
               "all required checks passed")


class _pil_only:
    """Decode with PIL for the duration: the native library looks unloaded."""

    def __enter__(self):
        from zsgnet_tpu_torch.data import native

        self.native, self.lib = native, native._lib
        native._lib = None

    def __exit__(self, *exc):
        self.native._lib = self.lib


def _child(args: list, cwd: Path) -> subprocess.Popen:
    """A ``python -m`` child of the checkout, its output piped."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    return subprocess.Popen([sys.executable, "-m", *args], cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _decode_numbers(root: Path) -> dict:
    """Decode ms per image of 64 of phase 6's 300² PNGs from bytes in memory:
    the native pipeline against PIL called directly, and their largest
    pixel difference (≤ 2/255)."""
    import io

    from PIL import Image

    from zsgnet_tpu_torch.data import native

    blobs = [p.read_bytes() for p in sorted((root / "images").glob("*.png"))[:64]]
    if len(blobs) != 64:
        raise AssertionError(f"{len(blobs)} PNGs under {root / 'images'}, expected 64 or more")

    def pil(b):
        with Image.open(io.BytesIO(b)) as im:
            return np.asarray(im.convert("RGB").resize((300, 300), Image.BILINEAR), np.uint8)

    fns = {"native": lambda b: native.image_load_u8(b, (300, 300))[0], "pil": pil}
    times, outs = {k: [] for k in fns}, {}
    for _ in range(3):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            outs[name] = [fn(b) for b in blobs]
            times[name].append((time.perf_counter() - t0) * 1e3 / len(blobs))
    diff = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) for a, b in zip(outs["native"], outs["pil"]))
    if diff > 2:
        raise AssertionError(f"native and PIL decodes differ by {diff}/255, more than 2/255")
    return {"decode_native_ms_per_image": statistics.median(times["native"]),
            "decode_pil_ms_per_image": statistics.median(times["pil"]), "decode_max_diff_255": diff}


def _loader_numbers(kw: dict) -> dict:
    """The train loader's host ms per batch (B = BATCH, ``cfg.nw`` threads),
    four ways: the CSV path (native decode, then PIL only), the packed cache
    and host normalization. ``*_assemble_ms``: one batch decoded and
    collated on the calling thread (the host work a batch costs);
    ``*_iter_ms``: the prefetching iterator's wall time per batch over 3
    epochs. Timed with ``utils.profiling.Timer``. The packed cache is built
    first (its seconds reported), every image decoded natively."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.utils.profiling import Timer

    from zsgnet_tpu_torch.data import native

    base = get_default_cfg().replace(**kw)
    native.reset_counts()
    t0 = time.perf_counter()
    data = get_data(base.replace(use_packed_cache=True))
    numbers = {"packed_build_s": time.perf_counter() - t0}
    rows = sum(len(dl.ds) for dl in (data.train_dl, data.valid_dl, data.test_dl))
    if native.counts() != {"native": rows, "pil": 0}:
        raise AssertionError(f"the packed cache's build decoded {native.counts()}, expected {rows} native decodes")
    numbers["packed_build_images"] = rows
    timer = Timer()
    ways = {"csv": {}, "csv_pil": {}, "packed": {"use_packed_cache": True}, "float": {"normalize_on_device": False}}
    for name, over in ways.items():
        ctx = _pil_only() if name == "csv_pil" else contextlib.nullcontext()
        with ctx:
            dl = get_data(base.replace(**over)).train_dl
            batches = dl._batch_indices()
            for _ in range(2):
                for bi in range(len(batches)):
                    with timer.section(f"{name}_assemble"):
                        dl._assemble(bi, batches)
            n = 0
            with timer.section(f"{name}_epochs"):
                for epoch in range(3):
                    dl.set_epoch(epoch)
                    n += sum(1 for _ in dl)
        summary = timer.summary()
        numbers[f"{name}_assemble_ms"] = summary[f"{name}_assemble"]["mean_ms"]
        numbers[f"{name}_iter_ms"] = summary[f"{name}_epochs"]["total_s"] * 1e3 / n
    numbers["nw"] = base.nw
    return numbers


def _serving_decode(kw: dict) -> dict:
    """``prep_chunk`` (decode, resize, padding) of 1 and of BATCH requests,
    median of 5, native against PIL in this run."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.vocab import Vocab
    from zsgnet_tpu_torch.predict import prep_chunk

    cfg = get_default_cfg().replace(**kw)
    root = Path(kw["data_dir"]) / "synthetic"
    val = pd.read_csv(root / "csv_dir" / "val.csv")
    paths = [root / "images" / str(p) for p in val["img_id"][:BATCH]]
    queries = [str(q) for q in val["query"][:BATCH]]
    vocab = Vocab.load(root / "csv_dir" / "vocab.json")
    out = {}
    for n in (1, BATCH):
        out[f"serving_decode_native_ms_{n}"] = _median_ms(lambda n=n: prep_chunk(cfg, vocab, n, paths[:n], queries[:n]))
        with _pil_only():
            out[f"serving_decode_pil_ms_{n}"] = _median_ms(lambda n=n: prep_chunk(cfg, vocab, n, paths[:n], queries[:n]))
    return out


def _trace_device_ms(path: Path) -> float:
    """Sum of the kernel durations (ms) in a Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    return sum(e.get("dur", 0.0) for e in events if e.get("cat") == "kernel") / 1e3


def _eval_profile(kw: dict, tmp: Path, smi: str) -> dict:
    """``time_fn`` over the eval step at B = BATCH, a ``profile_trace`` of
    5 steps whose Chrome trace must hold kernel events, and the achieved
    rate ``flops_estimate(cfg) × BATCH / device ms``."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.parallel.train_step import make_eval_step
    from zsgnet_tpu_torch.utils.profiling import flops_estimate, profile_trace, time_fn

    cfg = get_default_cfg().replace(**kw)
    data = get_data(cfg)
    batch = next(iter(data.valid_dl))
    model = get_default_net(cfg, len(data.vocab), seed=SEED, device=CUDA)
    step = make_eval_step(cfg, anchor_pyramid_for(cfg), device=CUDA)
    secs, ev = time_fn(step, model, batch, warmup=3, iters=20)
    if not torch.isfinite(ev["loss"]).all():
        raise AssertionError("non-finite eval loss under time_fn")
    for attempt in range(3):  # the profiler now and then returns a window without device events
        with profile_trace(tmp / "trace") as prof:
            for _ in range(5):
                step(model, batch)
        device_ms = _trace_device_ms(prof.trace_path) / 5
        if device_ms > 0:
            break
    else:
        raise AssertionError(f"profile_trace wrote {prof.trace_path} without kernel events, 3 times")
    flops = flops_estimate(cfg)
    return {"eval_time_fn_ms": secs * 1e3, "eval_device_ms": device_ms, "flops_per_query": flops,
            "achieved_tflops": flops * BATCH / (device_ms / 1e3) / 1e12, "trace_bytes": prof.trace_path.stat().st_size}


def check_host_data(tmp: Path, run_dir: Path, smi: str) -> list[int]:
    """Phase 11, the host data path and the operator tools, on phase 6's
    300² synthetic data and checkpoint: the native library (built with g++
    here; every PNG of the phase must decode through it), decode and loader
    host ms, the packed cache's build, serving decode, one packed epoch of
    ``main_dist`` (its first batch byte-equal to the CSV path's, K1 and K2
    once a step), the profiling helpers on the eval step, then the doctor,
    the demo, ``ckpt_info`` and ``viz`` as a user runs them. Returns the
    (K1, K2, K3) launches of the packed run."""
    from zsgnet_tpu_torch import ckpt_info
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data import native
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.data.packed import PackedDataset
    from zsgnet_tpu_torch.main import main_dist
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    status = native.status()
    log(f"host data: native library {status!r} (has_jpeg {native.has_jpeg()}) in {time.perf_counter() - t0:.2f} s")
    if not native.available():
        raise AssertionError(f"the native image library did not build on this machine: {status}")
    root = tmp / "synthetic"
    kw = dict(ds_to_use="synthetic", data_dir=str(tmp), tmp_path=str(run_dir), epochs=1, bs=BATCH, seed=SEED,
              log_every=1)
    numbers = _decode_numbers(root)
    numbers.update(_loader_numbers(kw))
    numbers.update(_serving_decode(kw))
    log(f"host data numbers on {smi}: {json.dumps(numbers)}")

    # One packed epoch through main_dist; its first batch is the CSV path's.
    # From here on every decode must go through the native library.
    native.reset_counts()
    cfg = get_default_cfg().replace(**kw)
    csv_first = get_data(cfg).train_dl.first_batch()
    packed = get_data(cfg.replace(use_packed_cache=True))
    if not isinstance(packed.train_dl.ds, PackedDataset):
        raise AssertionError(f"use_packed_cache loaded {type(packed.train_dl.ds).__name__}")
    packed_first = packed.train_dl.first_batch()
    for k, v in csv_first.items():
        if v.dtype != packed_first[k].dtype or v.tobytes() != packed_first[k].tobytes():
            raise AssertionError(f"packed first batch differs from the CSV path's at {k!r}")
    kernels = (fused_match_loss, fused_match_loss_backward, fused_bottleneck_infer)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    metrics = main_dist("packed", device=CUDA, use_packed_cache=True, **kw)
    torch.cuda.synchronize()
    launches = [k.launches for k in kernels]
    rows = {uid: json.loads((run_dir / "logs" / f"{uid}.jsonl").read_text().splitlines()[-1])
            for uid in ("smoke", "packed")}
    steps, val_batches = rows["packed"]["step"], len(packed.valid_dl)
    # K2 once a train step; K1 once a train step and once a validation batch
    # (fit validates the epoch, main_dist once more after it).
    if launches != [steps + 2 * val_batches, steps, 0] or steps != N_TRAIN // BATCH:
        raise AssertionError(f"packed run: {steps} steps, {val_batches} val batches, (K1, K2, K3) launches {launches}")
    if not all(np.isfinite(v) for v in metrics.values()) or not np.isfinite(rows["packed"]["train_total"]):
        raise AssertionError(f"packed run metrics {metrics}, row {rows['packed']}")
    t_packed = time.perf_counter() - t0
    # The same epoch through the CSV path, warm as the packed run was (phase
    # 6's epoch was the process's first, cold).
    main_dist("csv_warm", device=CUDA, **kw)
    rows["csv_warm"] = json.loads((run_dir / "logs" / "csv_warm.jsonl").read_text().splitlines()[-1])
    numbers.update(packed_qps=rows["packed"]["qps"], csv_warm_qps=rows["csv_warm"]["qps"],
                   csv_qps_phase6=rows["smoke"]["qps"])
    log(f"packed main_dist: 1 epoch of {steps} steps + validation in {t_packed:.2f} s, (K1, K2, K3) "
        f"launches {launches}; first batch byte-equal to the CSV path's; epoch qps packed {rows['packed']['qps']} "
        f"vs the CSV path's {rows['csv_warm']['qps']} right after it (phase 6's cold epoch {rows['smoke']['qps']}) "
        f"on {smi}")
    counts = native.counts()
    if counts["pil"] or not counts["native"]:
        raise AssertionError(f"decodes by path {counts}: every synthetic PNG must decode natively")
    log(f"decodes of the packed run and its first-batch check, by path: {counts}")

    numbers.update(_eval_profile(kw, tmp, smi))
    log(f"profiling on {smi}: eval step B={BATCH} time_fn {numbers['eval_time_fn_ms']:.3f} ms/call, device "
        f"{numbers['eval_device_ms']:.3f} ms/call from the Chrome trace, flops_estimate "
        f"{numbers['flops_per_query']:.4g}/query → {numbers['achieved_tflops']:.2f} TFLOP/s achieved")

    # The tools, as a user runs them: doctor, demo and viz in processes of their own.
    model_dir = run_dir / "models" / "smoke"
    children = {}
    try:
        children["doctor"] = _child(["zsgnet_tpu_torch.doctor"], tmp)
        (tmp / "demo").mkdir()
        children["demo"] = _child(["zsgnet_tpu_torch.demo", "--workdir=."], tmp / "demo")
        children["viz"] = _child(["zsgnet_tpu_torch.viz", str(model_dir), f"--csv={root / 'csv_dir' / 'val.csv'}",
                                  f"--out_dir={tmp / 'gallery'}", f"--n={BATCH}", f"--batch_size={BATCH}"], tmp)
        outs = {name: p.communicate(timeout=300)[0] for name, p in children.items()}
    finally:
        for p in children.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in children.items():
        log(f"{name} (exit {p.returncode}):\n" + "\n".join("    " + x for x in outs[name].strip().splitlines()[-16:]))
        if p.returncode != 0:
            raise AssertionError(f"python -m zsgnet_tpu_torch.{name} exited {p.returncode}")
    for row in DOCTOR_ROWS:
        if row not in outs["doctor"]:
            raise AssertionError(f"doctor output lacks {row!r}")
    drift = float(outs["demo"].split("box drift vs live = ")[1].split()[0])
    if not drift < 2e-2:
        raise AssertionError(f"demo box drift {drift}")
    panels = sorted((tmp / "gallery").glob("*.png"))
    if len(panels) != BATCH or json.loads(outs["viz"].strip().splitlines()[-1])["panels"] != BATCH:
        raise AssertionError(f"viz wrote {len(panels)} panels, expected {BATCH}")
    info = ckpt_info.describe(model_dir)
    cfg_ckpt = get_default_cfg().replace(**json.loads((model_dir / "cfg.json").read_text()))
    n_params = sum(p.numel() for p in ZSGNet(cfg_ckpt, cfg_ckpt.vocab_size).parameters())
    if info["elements"]["params"] != n_params or info["latest_step"] != N_TRAIN // BATCH or info["epoch"] != 1:
        raise AssertionError(f"ckpt_info {info['elements']} step {info['latest_step']}, the model has {n_params}")
    art = ckpt_info.describe(tmp / "demo" / "artifact")
    if art["platforms"] != [CUDA.type] or list(art["programs"]) != [f"{CUDA.type}/serving_fn.pt2"]:
        raise AssertionError(f"ckpt_info on the demo's artifact: {art}")
    numbers["demo_box_drift"] = drift
    log(f"tools: doctor ok, demo box drift {drift:.2e}, viz {len(panels)} panels, ckpt_info params "
        f"{info['elements']['params']} == the model's {n_params}, artifact {art['programs']}")
    log(f"host data and tools phase passed in {time.perf_counter() - t_phase:.1f} s on {smi}; numbers "
        f"{json.dumps(numbers)}")
    return launches


# ------------------------------------------------------------ phase 12

DP_STEPS = 3  # float32 steps of the world-2 run at lr 1e-6
DP_KEY = "DP_RESULT "  # a worker's result line


def _torchrun(nproc: int, mode: str, args: dict, timeout: float = 420.0, worker: str = "--dp-worker") -> str:
    """``python -m torch.distributed.run --standalone --nproc_per_node=nproc``
    on this script's data-parallel (or, ``worker="--sp-worker"``, spatial)
    worker (``mode``, ``args``); → its output. Fails on a non-zero exit or
    the timeout."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}",
           str(Path(__file__).resolve()), worker, mode, json.dumps(args)]
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}
    r = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise AssertionError(f"torchrun {mode} exited {r.returncode}:\n{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return r.stdout


def _dp_results(out: str) -> list[dict]:
    return [json.loads(x[len(DP_KEY):]) for x in out.splitlines() if x.startswith(DP_KEY)]


def _dp_nccl_worker(args: dict) -> None:
    """Phase 12a, one NCCL rank: the command line's ``main()`` under
    ``--multi_host=True`` for one epoch, then the data-parallel train step
    against the plain one, in turns."""
    import torch.distributed as dist

    from zsgnet_tpu_torch import main as t_main
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.parallel.mesh import init_distributed
    from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step

    kw = args["kw"]
    _zero_counts()
    sys.argv = ["zsgnet_tpu_torch.main", "dp_nccl", "--multi_host=True", *[f"--{k}={v}" for k, v in kw.items()]]
    t0 = time.perf_counter()
    t_main.main()
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, _counts()

    mesh = init_distributed("cuda")
    cfg = get_default_cfg().replace(**kw)
    data = get_data(cfg, shard_id=mesh.rank, num_shards=mesh.world_size)
    batches = list(data.train_dl)
    anchors = anchor_pyramid_for(cfg)
    steps = {}
    for name, m in (("ddp", mesh), ("plain", None)):
        model = get_default_net(cfg.replace(bn_sync_axis=cfg.data_axis) if m else cfg, len(data.vocab),
                                seed=cfg.seed, device=mesh.device)
        steps[name] = (make_train_step(cfg, anchors, mesh.device, m), create_train_state(cfg, model))
    times: dict[str, list[float]] = {"ddp": [], "plain": []}
    for i in range(8):
        for name, (step, state) in steps.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t1) * 1e3)
    device_ms = {}
    for name, (step, state) in steps.items():
        kernels = device_kernels(lambda: step(state, batches[0]), 3)
        device_ms[name] = sum(t for _, t, _ in kernels)
        device_ms[f"{name}_nccl"] = sum(t for k, t, _ in kernels if "nccl" in k.lower())
    backend = mesh.backend
    dist.destroy_process_group()
    print(DP_KEY + json.dumps({"rank": mesh.rank, "backend": backend, "main_wall_s": wall, "launches": launches,
                               "step_ms": {k: statistics.median(v[2:]) for k, v in times.items()},
                               "step_ms_all": times, "device_ms": device_ms}), flush=True)


def _dp_gloo_worker(args: dict) -> None:
    """Phase 12b, one of two gloo ranks sharing ``cuda:0``: DP_STEPS float32
    train steps of its half of each global batch, validation, K1 and K2 held
    against their plain versions on its own outputs, and the all-reduce's
    share of a step from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.parallel.mesh import init_distributed
    from zsgnet_tpu_torch.parallel.train_step import pairs_and_weights, to_device
    from zsgnet_tpu_torch.train.learner import Learner

    mesh = init_distributed("cuda:0", backend="gloo")
    cfg = get_default_cfg().replace(**args["kw"])
    data = get_data(cfg, shard_id=mesh.rank, num_shards=mesh.world_size)
    learn = Learner("dp_gloo", data, cfg, device=mesh.device, mesh=mesh)
    batches = [b for b, _ in zip(data.train_dl, range(DP_STEPS))]
    _zero_counts()
    losses = []
    for b in batches:
        learn.state, ls = learn.train_step(learn.state, b)
        losses.append({k: float(v) for k, v in ls.items()})
    torch.cuda.synchronize()
    launches = _counts()
    metrics = learn.validate()
    b0 = to_device(batches[0], mesh.device)
    with torch.no_grad():
        out = learn.model.eval()(b0["img"], b0["qvec"], b0["qlens"])
    annot, w = pairs_and_weights(b0)
    w = torch.ones(annot.shape[0], device=mesh.device) if w is None else w
    errs = hold_loss_kernels(f"rank {mesh.rank} of 2 (gloo, cuda:0)", cfg, out, annot, w, learn.anchors)
    if mesh.rank == 0:
        torch.save({k: v.cpu() for k, v in learn.model.state_dict().items()}, Path(args["out"]) / "gloo_state.pt")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learn.train_step(learn.state, batches[0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        learn.train_step(learn.state, batches[0])
        torch.cuda.synchronize()
    # The label's host range (host events; the window's device events are
    # the ones the profiler now and then drops). It also shows on the
    # device's timeline under the same name, which would count it twice.
    ar = [e for e in prof.key_averages() if e.key == "dp::all_reduce" and e.device_type == DeviceType.CPU]
    if not ar:
        raise AssertionError(f"rank {mesh.rank}: no dp::all_reduce range in the profile of a step")
    ar_ms = sum(e.cpu_time_total for e in ar) / 1e3
    print(DP_KEY + json.dumps({
        "rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device), "losses": losses,
        "launches": launches, "metrics": metrics, "k1_err": errs[0], "k2_err": errs[1],
        "step_ms": statistics.median(times), "all_reduce_ms": ar_ms,
        "all_reduce_calls": sum(e.count for e in ar)}), flush=True)
    torch.distributed.destroy_process_group()


def dp_worker(mode: str, args: str) -> int:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    {"nccl": _dp_nccl_worker, "gloo": _dp_gloo_worker}[mode](json.loads(args))
    return 0


def _state_close(name: str, got: dict, want: dict, p0: dict) -> tuple[float, float]:
    """The CPU tests' tolerances (tests/test_torch_multihost.py): BatchNorm
    statistics within atol 1e-3, parameter updates (Adam) within relative L2
    0.25. → (largest statistic difference, update relative L2)."""
    stats = [k for k in want if "running_" in k]
    bn = max((float((got[k].double() - want[k].double()).abs().max()) for k in stats), default=0.0)
    params = [k for k in want if want[k].is_floating_point() and k not in stats]
    d_got = torch.cat([(got[k].double() - p0[k].double()).ravel() for k in params])
    d_want = torch.cat([(want[k].double() - p0[k].double()).ravel() for k in params])
    rel = float((d_got - d_want).norm() / d_want.norm())
    if bn > 1e-3 or rel > 0.25:
        raise AssertionError(f"{name}: BatchNorm statistics off by {bn:.3g} (atol 1e-3), updates by "
                             f"relative L2 {rel:.3g} (0.25)")
    return bn, rel


def check_data_parallel(tmp: Path, run_dir: Path, smi: str) -> tuple[list[int], dict]:
    """Phase 12, data parallel on the one card, on phase 6's data and
    checkpoint. (a) ``torchrun --nproc_per_node=1`` on the command line's
    ``main()`` with ``--multi_host=True``: NCCL at world 1 against a plain
    ``main_dist`` of the same config and seed (the same log row within the
    bf16 range, K1/K2 at 10/4), the data-parallel step timed against the
    plain one. (b) Two gloo ranks sharing ``cuda:0``, float32, lr 1e-6,
    against one process on the same global batches (losses, parameters,
    BatchNorm statistics, validation), K1 and K2 held on each rank's
    outputs, one launch each per step and rank. (c) Data-parallel serving:
    ``load_server_model(data_parallel=True)`` and a two-replica Grounder
    against the single-device Grounder in float32, with no kernel launch.
    Returns the (K1, K2, K3) launches of (c), and K1's and K2's launches in
    (a) and on each rank of (b)."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.main import main_dist
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward
    from zsgnet_tpu_torch.predict import Grounder
    from zsgnet_tpu_torch.serve import load_server_model
    from zsgnet_tpu_torch.train.learner import Learner

    t_phase = time.perf_counter()
    numbers: dict = {}
    kw = dict(ds_to_use="synthetic", data_dir=str(tmp), tmp_path=str(tmp / "dp_run"), epochs=1, bs=BATCH,
              seed=SEED, log_every=1)
    # (a) NCCL at world 1 through the command line, against a plain main_dist.
    t0 = time.perf_counter()
    out = _torchrun(1, "nccl", {"kw": kw})
    (a,) = _dp_results(out)
    t_a = time.perf_counter() - t0
    if a["backend"] != "nccl" or "process group: nccl, 1 rank(s)" not in out:
        raise AssertionError(f"the torchrun child's process group is {a['backend']}, not nccl")
    _zero_counts()
    main_dist("dp_plain", device=CUDA, **kw)
    torch.cuda.synchronize()
    plain_launches = _counts()
    rows = {uid: [json.loads(x) for x in (tmp / "dp_run" / "logs" / f"{uid}.jsonl").read_text().splitlines()]
            for uid in ("dp_nccl", "dp_plain")}
    r_dp, r_pl = rows["dp_nccl"][-1], rows["dp_plain"][-1]
    if len(rows["dp_nccl"]) != 1 or not (tmp / "dp_run" / "models" / "dp_nccl" / "best").is_dir():
        raise AssertionError(f"the NCCL run wrote {len(rows['dp_nccl'])} log rows and no best/ checkpoint")
    if tuple(a["launches"]) != plain_launches or plain_launches != (10, 4):
        raise AssertionError(f"(K1, K2) launches: NCCL run {a['launches']}, plain run {plain_launches}; "
                             "expected (10, 4)")
    keys = ("train_total", "train_cls_ls", "train_box_ls", "train_loss_smooth", "val_loss", "val_MeanIoU")
    rel = {k: abs(r_dp[k] - r_pl[k]) / max(abs(r_pl[k]), 1e-12) for k in keys}
    if (r_dp["step"], r_dp["val_num_samples"]) != (r_pl["step"], r_pl["val_num_samples"]) or max(rel.values()) > 5e-2 \
            or abs(r_dp["val_Acc"] - r_pl["val_Acc"]) > 0.05 or not all(np.isfinite(r_dp[k]) for k in keys):
        raise AssertionError(f"NCCL world-1 row {r_dp} vs the plain run's {r_pl} (bf16 range: rtol 5e-2)")
    numbers["a"] = {"rel_diff": rel, "acc": (r_dp["val_Acc"], r_pl["val_Acc"]), "launches": a["launches"],
                    "step_ms": a["step_ms"], "device_ms": a["device_ms"], "child_s": t_a}
    log(f"data parallel (a): torchrun NCCL world 1, main() --multi_host=True in {a['main_wall_s']:.1f} s "
        f"(child {t_a:.1f} s); log row vs plain main_dist relative differences "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} }, val Acc {r_dp['val_Acc']} vs {r_pl['val_Acc']}; "
        f"(K1, K2) {a['launches']} == plain {plain_launches}; train step B={BATCH} bf16 in turns on {smi}: "
        f"data parallel {a['step_ms']['ddp']:.3f} ms vs plain {a['step_ms']['plain']:.3f} ms (median of 6), "
        f"device {a['device_ms']['ddp']:.3f} vs {a['device_ms']['plain']:.3f} ms/step, NCCL kernels "
        f"{a['device_ms']['ddp_nccl']:.3f} ms/step")

    # (b) Two gloo ranks on cuda:0 against one process, float32.
    kw_b = dict(kw, compute_dtype="float32", lr=1e-6, tmp_path=str(tmp / "dp_gloo"))
    t0 = time.perf_counter()
    ranks = sorted(_dp_results(_torchrun(2, "gloo", {"kw": kw_b, "out": str(tmp)})), key=lambda r: r["rank"])
    t_b = time.perf_counter() - t0
    cfg = get_default_cfg().replace(**kw_b)
    data = get_data(cfg)
    ref = Learner("dp_ref", data, cfg, device=CUDA)
    p0 = {k: v.detach().cpu().clone() for k, v in ref.model.state_dict().items()}
    want = []
    for b, _ in zip(data.train_dl, range(DP_STEPS)):
        ref.state, ls = ref.train_step(ref.state, b)
        want.append({k: float(v) for k, v in ls.items()})
    want_metrics = ref.validate()
    got_state = torch.load(tmp / "gloo_state.pt", weights_only=True)
    bn, rel_upd = _state_close("world 2 vs world 1", got_state, {k: v.cpu() for k, v in ref.model.state_dict().items()},
                               p0)
    for r in ranks:
        on = "cuda:0" if CUDA.type == "cuda" else "cpu"
        if r["backend"] != "gloo" or r["device"] != on or tuple(r["launches"]) != (DP_STEPS, DP_STEPS):
            raise AssertionError(f"rank {r['rank']}: {r['backend']} on {r['device']}, (K1, K2) {r['launches']}")
        for i, (g, w_) in enumerate(zip(r["losses"], want)):
            if g["num_pos"] != w_["num_pos"] or not np.allclose([g[k] for k in ("total", "cls_ls", "box_ls")],
                                                               [w_[k] for k in ("total", "cls_ls", "box_ls")],
                                                               rtol=1e-4, atol=0):
                raise AssertionError(f"rank {r['rank']} step {i}: losses {g} vs world 1 {w_} (rtol 1e-4)")
        m = r["metrics"]
        if (m["Acc"], m["MaxPos"], m["num_samples"]) != (want_metrics["Acc"], want_metrics["MaxPos"],
                                                        want_metrics["num_samples"]) or not np.allclose(
                [m["MeanIoU"], m["loss"]], [want_metrics["MeanIoU"], want_metrics["loss"]], rtol=1e-5):
            raise AssertionError(f"rank {r['rank']} validation {m} vs world 1 {want_metrics}")
    share = [r["all_reduce_ms"] / r["step_ms"] for r in ranks]
    numbers["b"] = {"child_s": t_b, "bn_max_diff": bn, "update_rel_l2": rel_upd,
                    "loss_rel": max(abs(g["total"] - w_["total"]) / w_["total"] for r in ranks
                                    for g, w_ in zip(r["losses"], want)),
                    "step_ms": [r["step_ms"] for r in ranks], "all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
                    "all_reduce_calls": [r["all_reduce_calls"] for r in ranks], "all_reduce_share": share,
                    "k1_err": [r["k1_err"] for r in ranks], "k2_err": [r["k2_err"] for r in ranks]}
    log(f"data parallel (b): 2 gloo ranks sharing cuda:0 ({t_b:.1f} s), {DP_STEPS} float32 steps of B={BATCH} "
        f"({BATCH // 2} a rank) == world 1: losses within {numbers['b']['loss_rel']:.2e} relative, BatchNorm "
        f"statistics within {bn:.2e}, updates relative L2 {rel_upd:.3g}, validation {want_metrics}; K1/K2 (1, 1) per step "
        f"per rank, held on each rank's outputs (max abs err K1 {numbers['b']['k1_err']}, K2 "
        f"{numbers['b']['k2_err']}); gloo on one card, not a scaling figure: all-reduce "
        f"{[round(x, 2) for x in numbers['b']['all_reduce_ms']]} ms in {numbers['b']['all_reduce_calls']} calls "
        f"of a {[round(x, 2) for x in numbers['b']['step_ms']]} ms step = {[f'{x:.1%}' for x in share]} on {smi}")
    del ref, data

    # (c) Data-parallel serving against the single-device Grounder, float32.
    kernels = (fused_match_loss, fused_match_loss_backward, fused_bottleneck_infer)
    for k in kernels:
        k.launches = 0
    model_dir = run_dir / "models" / "smoke"
    f32 = {"compute_dtype": "float32"}
    one = Grounder.from_checkpoint(model_dir, batch_size=BATCH, cfg_overrides=f32, device=CUDA)
    dp = load_server_model(model_dir, batch_size=BATCH, cfg_overrides=f32, data_parallel=True, device=CUDA)
    two = Grounder.from_checkpoint(model_dir, batch_size=BATCH, cfg_overrides=f32, devices=["cuda:0", "cuda:0"])
    every = [torch.device(CUDA.type, i) for i in range(torch.cuda.device_count())] if CUDA.type == "cuda" else [CUDA]
    if dp.devices != every or len(two.replicas) != 2:
        raise AssertionError(f"data-parallel Grounders on {dp.devices} and {two.devices}")
    val = pd.read_csv(tmp / "synthetic" / "csv_dir" / "val.csv")
    paths = [tmp / "synthetic" / "images" / str(p) for p in val["img_id"]][:BATCH + 3]
    queries = [str(q) for q in val["query"]][:BATCH + 3]
    want_res = one.ground(paths, queries)
    errs = {}
    for name, g in (("load_server_model(data_parallel=True)", dp), ("two replicas on cuda:0", two)):
        anchors = None
        if name.startswith("two"):  # each replica runs half of every padded chunk
            anchors = (_replica_anchors(g, paths, queries), _replica_anchors(one, paths, queries))
        errs[name] = _held_results(name, g.ground(paths, queries), want_res, anchors)
    errs["ground_image two replicas"] = _held_results(
        "ground_image two replicas", two.ground_image(paths[0], queries[:5]), one.ground_image(paths[0], queries[:5]))
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"data-parallel serving launched (K1, K2, K3) {launches}")
    numbers["c"] = errs
    log(f"data parallel (c): serving on {dp.devices} and on two replicas == the single-device Grounder, float32 "
        f"max score differences {errs}; (K1, K2, K3) launches {launches}")
    log(f"data parallel phase passed in {time.perf_counter() - t_phase:.1f} s on {smi}; numbers "
        f"{json.dumps(numbers)}")
    return launches, {"nccl_world1": a["launches"], "gloo_per_rank": [r["launches"] for r in ranks]}


def _replica_anchors(g, paths: list, queries: list) -> list[int]:
    """Each request's argmax anchor as ``g`` computes it chunk by chunk:
    every replica on its slice of each padded chunk."""
    from zsgnet_tpu_torch.predict import prep_chunk

    out = []
    for start in range(0, len(paths), g.bs):
        chunk = paths[start:start + g.bs]
        pad = g._pad_to(len(chunk))
        img, qvec, qlens, _, k = prep_chunk(g.cfg, g.vocab, pad, chunk, queries[start:start + g.bs])
        rows = pad // len(g.replicas)
        with torch.inference_mode():
            for i, (model, _) in enumerate(g.replicas):
                sl = slice(i * rows, (i + 1) * rows)
                att = model(torch.from_numpy(img[sl]).to(CUDA), torch.from_numpy(qvec[sl]).to(CUDA),
                            torch.from_numpy(qlens[sl]), canvas=g.canvas_for(pad))["att_out"]
                out.extend(att.argmax(dim=-1).tolist())
        out = out[: start + k]
    return out


# ------------------------------------------------------------ phase 13

SP_SIZES = (600, 300)  # the reference's larger config, then the default
SP_STEPS = 3  # float32 steps of global B = 4 at lr 1e-6
SP_BATCH = 4
SP_VOCAB = 1000
# (a) and (a′): (model, size, global batch, steps) on the two ranks, each
# against one process; (a″): SSD-VGG16 at one sample (the members gather it).
SP_CASES = tuple((mdl, res, SP_BATCH, SP_STEPS) for mdl in ("retina", "ssd_vgg") for res in SP_SIZES) + (
    ("ssd_vgg", 600, 1, 2),)
SP_EVAL_B1 = 600  # (a″): the retina Learner's evaluation at B = 1, at this size


def _sp_cfg(res: int, mdl: str = "retina", bs: int = SP_BATCH):
    from zsgnet_tpu_torch.config import get_default_cfg

    return get_default_cfg().replace(resize_img=(res, res), bs=bs, compute_dtype="float32", lr=1e-6,
                                     mesh_spatial=2, seed=SEED, mdl_to_use=mdl)


def _sp_tag(mdl: str, res: int, bs: int) -> str:
    return f"{mdl}_{res}_b{bs}"


def _sp_batches(cfg, steps: int = SP_STEPS) -> list[dict]:
    """``steps`` global batches at ``cfg``'s size, from the seed: uint8
    images, queries of 3–11 tokens, one box each."""
    h, w = cfg.resize_img
    out = []
    for i in range(steps):
        rng = np.random.default_rng((SEED, h, i))
        b, t = cfg.bs, cfg.max_qlen
        qlens = rng.integers(3, min(12, t + 1), size=(b,)).astype(np.int32)
        qvec = np.where(np.arange(t)[None] < qlens[:, None], rng.integers(1, SP_VOCAB, size=(b, t)), 0)
        lo = rng.uniform(-1.0, 0.5, size=(b, 2))
        annot = np.clip(np.concatenate([lo, lo + rng.uniform(0.2, 0.9, size=(b, 2))], axis=1), -1.0, 1.0)
        out.append({"img": rng.integers(0, 256, size=(b, h, w, 3)).astype(np.uint8), "qvec": qvec.astype(np.int32),
                    "qlens": qlens, "annot": annot.astype(np.float32)})
    return out


def _sp_learner_cfg(data_dir: str, tmp: Path, spatial: int):
    """(a″)'s Learner: retina at SP_EVAL_B1², B = 1, float32, on phase 6's data."""
    return _sp_cfg(SP_EVAL_B1, "retina", 1).replace(ds_to_use="synthetic", data_dir=data_dir,
                                                    tmp_path=str(tmp / f"sp_learn_{spatial}"), mesh_spatial=spatial)


def _label_ms(prof, name: str) -> dict:
    """A profiler label's calls, host ms and the device ms of what ran under
    it, from its host ranges (its device-timeline copy would count twice)."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.key_averages() if e.key == name and e.device_type == DeviceType.CPU]
    if not ev:
        raise AssertionError(f"no {name} range in the profile of a spatial step")
    return {"calls": sum(e.count for e in ev), "host_ms": sum(e.cpu_time_total for e in ev) / 1e3,
            "device_ms": sum(e.device_time_total for e in ev) / 1e3}


def _peak_without_cudnn(step, state, batch) -> int:
    """Bytes one warm train step allocates above what was allocated before
    it, with cuDNN off: the activations without the convolutions' workspace,
    which cuDNN sizes by its own choice of algorithm per shape (at 300² it
    can dwarf the activations of a float32 SSD-VGG16 step)."""
    torch.backends.cudnn.enabled = False
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, batch)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base
    finally:
        torch.backends.cudnn.enabled = True


def _sp_rank_case(world, mdl: str, res: int, bs: int, steps: int, out_dir: Path) -> None:
    """One SP_CASES case on this rank: ``steps`` float32 train steps of the
    global batch (each rank its half of the image rows), an eval step on the
    first batch, where the reshard (or gather) landed, the peak memory, the
    time under ``sp::halo`` and ``sp::reshard`` in a profiled step, and K1
    and K2 held against their plain versions on the rank's post-reshard
    block (the whole batch, weighted 1/S, where it gathered); the results
    go to ``<out>/sp_<tag>_rank<r>.json`` and the state after the steps to
    ``<out>/sp_<tag>_state_rank<r>.pt``."""
    from torch.profiler import ProfilerActivity, profile

    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.parallel.mesh import make_mesh
    from zsgnet_tpu_torch.parallel.train_step import (
        create_train_state, make_eval_step, make_train_step, member_pairs, to_device,
    )

    cfg = _sp_cfg(res, mdl, bs)
    tag = _sp_tag(mdl, res, bs)
    mesh = make_mesh(cfg, world.device)
    batches = _sp_batches(cfg, steps)
    model = get_default_net(cfg, SP_VOCAB, seed=SEED, device=mesh.device)
    state = create_train_state(cfg, model)
    anchors = anchor_pyramid_for(cfg)
    step = make_train_step(cfg, anchors, mesh.device, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_counts()
    losses = []
    t0 = time.perf_counter()
    for b in batches:
        state, ls = step(state, b)
        losses.append({k: float(v) for k, v in ls.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, peak = _counts(), torch.cuda.max_memory_allocated()
    # The state after the steps, before the eval and timed steps.
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, out_dir / f"sp_{tag}_state_rank{mesh.rank}.pt")
    _zero_counts()
    ev = make_eval_step(cfg, anchors, mesh.device, mesh)(model, dict(batches[0], valid=np.ones(cfg.bs, bool)))
    torch.cuda.synchronize()
    eval_launches = _counts()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(state, batches[0])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    no_cudnn = _peak_without_cudnn(step, state, batches[0])
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batches[0])
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t1) * 1e3
    labels = {name: _label_ms(prof, name) for name in ("sp::halo", "sp::reshard", "dp::all_reduce")}
    sp = step.spatial
    d = to_device(dict(batches[0], img=sp.rows(batches[0]["img"])), mesh.device)
    with torch.no_grad():
        out = model.eval()(d["img"], d["qvec"], d["qlens"], spatial=sp)
    annot, w = member_pairs(sp, d)
    w = torch.ones(annot.shape[0], device=mesh.device) if w is None else w
    errs = hold_loss_kernels(f"rank {mesh.rank} of 2 (gloo, cuda:0, mesh_spatial=2) {mdl} at {res}², B={bs}", cfg,
                             out, annot, w, anchors)
    (out_dir / f"sp_{tag}_rank{mesh.rank}.json").write_text(json.dumps({
        "rank": mesh.rank, "mdl": mdl, "res": res, "bs": bs, "backend": mesh.backend, "device": str(mesh.device),
        "mesh": [mesh.data_size, mesh.spatial, mesh.spatial_index], "losses": losses, "launches": launches,
        "eval_launches": eval_launches, "eval_loss": float(ev["loss"][0]) if len(ev["loss"]) else None,
        "eval_iou": ev["iou"].tolist(),
        "landed": {k: list(v) for k, v in sp.landed.items()}, "peak_bytes": peak, "base_bytes": base,
        "no_cudnn_step_bytes": no_cudnn, "steps_s": wall,
        "step_ms": statistics.median(times), "profiled_step_ms": profiled_ms, "labels": labels,
        "k1_err": errs[0], "k2_err": errs[1], "block_rows": int(annot.shape[0])}))
    del model, state, step, out
    torch.cuda.empty_cache()


def _sp_gloo_worker(args: dict) -> None:
    """Phase 13a, a′ and a″, one of two gloo ranks sharing ``cuda:0`` under
    ``mesh_spatial=2``: every SP_CASES case (``_sp_rank_case``), then the
    retina Learner's validation at B = 1 on phase 6's data (``<out>/
    sp_learn_b1_rank<r>.json``)."""
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.parallel.mesh import data_shard, init_distributed, make_mesh
    from zsgnet_tpu_torch.train.learner import Learner

    world = init_distributed("cuda:0", backend="gloo")
    out_dir = Path(args["out"])
    for mdl, res, bs, steps in SP_CASES:
        _sp_rank_case(world, mdl, res, bs, steps, out_dir)
    cfg = _sp_learner_cfg(args["data"], out_dir, 2)
    mesh = make_mesh(cfg, world.device)
    learn = Learner("sp_eval_b1", get_data(cfg, *data_shard(cfg)), cfg, device=mesh.device, mesh=mesh)
    _zero_counts()
    t0 = time.perf_counter()
    metrics = learn.validate()
    torch.cuda.synchronize()
    (out_dir / f"sp_learn_b1_rank{mesh.rank}.json").write_text(json.dumps({
        "rank": mesh.rank, "metrics": metrics, "launches": _counts(), "s": time.perf_counter() - t0,
        "batches": len(learn.data.valid_dl)}))
    del learn
    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()


def sp_worker(mode: str, args: str) -> int:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    {"gloo": _sp_gloo_worker}[mode](json.loads(args))
    return 0


def _spatial_anchors(g, images: list, queries: list) -> list[int]:
    """Each request's argmax anchor as the spatial Grounder ``g`` computes
    it: the chunk padded to its bucket, the height split over its members."""
    from zsgnet_tpu_torch.predict import prep_chunk

    img, qvec, qlens, _, k = prep_chunk(g.cfg, g.vocab, g._pad_to(len(images)), images, queries)
    img, qvec, qlens = torch.from_numpy(img), torch.from_numpy(qvec), torch.from_numpy(qlens)
    canvas = g.canvas_for(len(img))

    def member(d: int, ctx) -> list[int]:
        model, anchors = g.replicas[ctx.index]
        dev = anchors.device
        att = model(ctx.rows(img).to(dev), qvec.to(dev), qlens, canvas=canvas, spatial=ctx)["att_out"]
        return att.argmax(dim=-1).tolist()

    (rows,) = g.local_mesh.run(member)
    rows = rows if len(img) % g.spatial == 0 else rows[:1]
    return [a for r in rows for a in r][:k]


class _Daemon:
    """``python -m zsgnet_tpu_torch.serve`` on ``model_dir`` as a child, its
    output drained by a thread; ``url`` once it says it serves."""

    def __init__(self, model_dir: Path, args: list):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.url = f"http://127.0.0.1:{port}"
        self.proc = _child(["zsgnet_tpu_torch.serve", str(model_dir), f"--port={port}", *args],
                           Path(__file__).resolve().parent)
        self.lines: list[str] = []
        self.reader = threading.Thread(target=lambda: self.lines.extend(ln.rstrip() for ln in self.proc.stdout),
                                       daemon=True)
        self.reader.start()
        deadline = time.monotonic() + 300
        while not any(ln.startswith("serving ") for ln in list(self.lines)):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.stop()
                raise AssertionError("the spatial daemon did not start:\n" + "\n".join(self.lines[-40:]))
            time.sleep(0.2)

    def stop(self) -> str:
        """SIGTERM, then its exit; → its output."""
        self.proc.terminate()
        try:
            self.proc.wait(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
        self.reader.join(timeout=30)
        return "\n".join(self.lines)


def check_spatial(tmp: Path, run_dir: Path, smi: str) -> tuple[list[int], dict]:
    """Phase 13, spatial partitioning on the one card. Two gloo ranks
    sharing ``cuda:0`` with ``mesh_spatial=2`` (``torch.distributed.run``
    on this script's ``--sp-worker``) run every SP_CASES case: (a) retina
    and (a′) SSD-VGG16 at 600² and 300², SP_STEPS float32 steps of global
    B = 4 at lr 1e-6, and (a″) SSD-VGG16 at 600² and B = 1 (gathered), each
    against one process on the same batches (losses rtol 1e-4, ``num_pos``
    exact; each rank's parameters and BatchNorm statistics after the steps
    by ``_state_close``; an eval step's loss and IoU rows); each rank
    launches K1 and K2 once a step on its post-reshard block, and holds
    them against their plain versions. (a″) also validates retina through
    a Learner at 600² and B = 1 against one process's Learner. (b)
    ``Grounder(mesh_spatial=2)`` on ``["cuda:0", "cuda:0"]`` against the
    plain Grounder on phase 6's checkpoint in float32, buckets 1 and 16,
    and the int8 Grounders the same way; (b′) the same on phase 9's
    SSD-VGG16 checkpoint in float32. (c) ``serve.py --mesh_spatial=2`` as a
    process answers requests as the plain Grounder does. Returns the (K1,
    K2, K3) launches of (b), (b′) and (c), and K1's and K2's per rank and
    case in (a), (a′) and (a″)."""
    from zsgnet_tpu_torch.models.quant import quant_scales
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward
    from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_eval_step, make_train_step
    from zsgnet_tpu_torch.predict import Grounder

    t_phase = time.perf_counter()
    numbers: dict = {"a": {}}
    # (a), (a′), (a″): two gloo ranks on cuda:0 under mesh_spatial=2 against one process.
    t0 = time.perf_counter()
    out = _torchrun(2, "gloo", {"out": str(tmp), "data": str(tmp)}, timeout=900.0, worker="--sp-worker")
    t_a = time.perf_counter() - t0
    staged = "staged through host memory" in out
    sp_launches = {}
    on = "cuda:0" if CUDA.type == "cuda" else "cpu"
    for mdl, res, bs, steps in SP_CASES:
        tag = _sp_tag(mdl, res, bs)
        part = "a" if mdl == "retina" else ("a′" if bs % 2 == 0 else "a″")
        gathered = bs % 2 != 0
        rs = [json.loads((tmp / f"sp_{tag}_rank{r}.json").read_text()) for r in (0, 1)]
        cfg = _sp_cfg(res, mdl, bs).replace(mesh_spatial=1)
        batches = _sp_batches(cfg, steps)
        model = get_default_net(cfg, SP_VOCAB, seed=SEED, device=CUDA)
        p0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, anchor_pyramid_for(cfg), CUDA)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_one = torch.cuda.memory_allocated()
        want = []
        for b in batches:
            state, ls = step(state, b)
            want.append({k: float(v) for k, v in ls.items()})
        torch.cuda.synchronize()
        peak_one = torch.cuda.max_memory_allocated()
        # Each rank's parameters (and BatchNorm statistics) after the steps,
        # against the one process's (the gradients' and moments' check).
        want_state = {k: v.cpu() for k, v in model.state_dict().items()}
        state_close = []
        for r in (0, 1):
            f = tmp / f"sp_{tag}_state_rank{r}.pt"
            state_close.append(_state_close(f"{mdl} {res}² B={bs} rank {r} vs one process",
                                            torch.load(f, weights_only=True), want_state, p0))
            f.unlink()
        del p0, want_state
        ev = make_eval_step(cfg, anchor_pyramid_for(cfg), CUDA)(model, dict(batches[0], valid=np.ones(cfg.bs, bool)))
        ev_loss, ev_iou = float(ev["loss"][0]), ev["iou"].tolist()
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(state, batches[0])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        no_cudnn_one = _peak_without_cudnn(step, state, batches[0])
        del model, state, step
        torch.cuda.empty_cache()
        for r in rs:
            if r["backend"] != "gloo" or r["device"] != on or r["mesh"] != [1, 2, r["rank"]] \
                    or tuple(r["launches"]) != (steps, steps) or tuple(r["eval_launches"]) != (1, 0):
                raise AssertionError(f"{tag} rank {r['rank']}: {r['backend']} on {r['device']}, mesh {r['mesh']}, "
                                     f"(K1, K2) {r['launches']} in the steps, {r['eval_launches']} in the eval step")
            # The eval rows a rank answers for: its half, or, gathered, all on rank 0.
            half = bs // 2
            rows = (ev_iou if r["rank"] == 0 else []) if gathered else ev_iou[r["rank"] * half:(r["rank"] + 1) * half]
            loss_ok = r["eval_loss"] is None if (gathered and r["rank"]) else np.isclose(
                r["eval_loss"], ev_loss, rtol=1e-4, atol=0)
            if not loss_ok or len(r["eval_iou"]) != len(rows) or not np.allclose(r["eval_iou"], rows, rtol=0,
                                                                                 atol=1e-4):
                raise AssertionError(f"{tag} rank {r['rank']} eval step: loss {r['eval_loss']}, IoU {r['eval_iou']} "
                                     f"vs one process {ev_loss}, its rows {rows}")
            for i, (g, w_) in enumerate(zip(r["losses"], want)):
                if g["num_pos"] != w_["num_pos"] or not np.allclose([g[k] for k in ("total", "cls_ls", "box_ls")],
                                                                   [w_[k] for k in ("total", "cls_ls", "box_ls")],
                                                                   rtol=1e-4, atol=0):
                    raise AssertionError(f"{tag} rank {r['rank']} step {i}: losses {g} vs one process {w_} (rtol 1e-4)")
        if rs[0]["landed"] != rs[1]["landed"]:
            raise AssertionError(f"{tag}: the ranks resharded at {rs[0]['landed']} and {rs[1]['landed']}")
        sp_launches[tag] = [(r["launches"], r["eval_launches"]) for r in rs]
        rel = max(abs(g["total"] - w_["total"]) / w_["total"] for r in rs for g, w_ in zip(r["losses"], want))
        numbers["a"][tag] = {
            "landed": rs[0]["landed"], "loss_rel": rel, "num_pos": [w_["num_pos"] for w_ in want],
            "bn_max_diff": [bn for bn, _ in state_close], "update_rel_l2": [u for _, u in state_close],
            "peak_gib": [r["peak_bytes"] / 2**30 for r in rs], "peak_gib_one_process": peak_one / 2**30,
            # What the steps added to what each process held before them (the
            # parent still holds earlier phases' tensors).
            "step_peak_gib": [(r["peak_bytes"] - r["base_bytes"]) / 2**30 for r in rs],
            "step_peak_gib_one_process": (peak_one - base_one) / 2**30,
            "no_cudnn_step_gib": [r["no_cudnn_step_bytes"] / 2**30 for r in rs],
            "no_cudnn_step_gib_one_process": no_cudnn_one / 2**30,
            "step_ms": [r["step_ms"] for r in rs], "step_ms_one_process": statistics.median(times),
            "labels": [r["labels"] for r in rs], "profiled_step_ms": [r["profiled_step_ms"] for r in rs],
            "label_share": [{k: v["host_ms"] / r["profiled_step_ms"] for k, v in r["labels"].items()} for r in rs],
            "k1_err": [r["k1_err"] for r in rs],
            "k2_err": [r["k2_err"] for r in rs], "block_rows": [r["block_rows"] for r in rs]}
        n = numbers["a"][tag]
        log(f"spatial ({part}) {mdl} {res}²: 2 gloo ranks sharing cuda:0, mesh (data 1, spatial 2), {steps} float32 "
            f"steps of B={bs}{' (the members gather the one sample)' if gathered else ''} == one process: losses "
            f"within {rel:.2e} relative, num_pos {n['num_pos']} exact, "
            f"BatchNorm statistics within {[f'{x:.2e}' for x in n['bn_max_diff']]} (atol 1e-3) and the parameter "
            f"updates within relative L2 {[f'{x:.3g}' for x in n['update_rel_l2']]} (0.25) per rank; the "
            f"reshard landed at {list(n['landed'])} (local input shapes {list(n['landed'].values())}); peak "
            f"memory a rank {[round(x, 3) for x in n['peak_gib']]} GiB vs one process "
            f"{n['peak_gib_one_process']:.3f} GiB, above what each held before the steps "
            f"{[round(x, 3) for x in n['step_peak_gib']]} vs {n['step_peak_gib_one_process']:.3f} GiB "
            f"(ratio {[round(x / n['step_peak_gib_one_process'], 3) for x in n['step_peak_gib']]}), a warm step "
            f"without cuDNN's workspace {[round(x, 3) for x in n['no_cudnn_step_gib']]} vs "
            f"{n['no_cudnn_step_gib_one_process']:.3f} GiB (ratio "
            f"{[round(x / n['no_cudnn_step_gib_one_process'], 3) for x in n['no_cudnn_step_gib']]}); the eval step's "
            f"loss and each rank's IoU rows == one process's "
            f"(K1/K2 (1, 0) on it); K1/K2 (1, 1) per step per rank on its {n['block_rows']} "
            f"post-reshard rows, held on its outputs (max abs err K1 {n['k1_err']}, K2 {n['k2_err']}); step "
            f"{[round(x, 1) for x in n['step_ms']]} ms vs one process {n['step_ms_one_process']:.1f} ms; "
            f"sp::halo / sp::reshard / dp::all_reduce in a profiled step of "
            f"{[round(x, 1) for x in n['profiled_step_ms']]} ms (calls, host ms, device ms, host share): "
            f"{[{k: (v['calls'], round(v['host_ms'], 2), round(v['device_ms'], 3), f'{sh[k]:.1%}') for k, v in lab.items()} for lab, sh in zip(n['labels'], n['label_share'])]}"
            f" on {smi} — gloo on one card, not a scaling figure")
    # (a″) The retina Learner's validation at B = 1 (each spatial group gathers its sample).
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.train.learner import Learner

    learned = [json.loads((tmp / f"sp_learn_b1_rank{r}.json").read_text()) for r in (0, 1)]
    lcfg = _sp_learner_cfg(str(tmp), tmp, 1)
    learn = Learner("sp_eval_b1_one", get_data(lcfg), lcfg, device=CUDA)
    _zero_counts()
    t1 = time.perf_counter()
    lwant = learn.validate()
    torch.cuda.synchronize()
    one_s, one_launches, n_val = time.perf_counter() - t1, _counts(), len(learn.data.valid_dl)
    del learn
    torch.cuda.empty_cache()
    for r in learned:
        g = r["metrics"]
        if any(g[k] != lwant[k] for k in ("Acc", "MaxPos", "num_samples")) or abs(g["MeanIoU"] - lwant["MeanIoU"]) > 1e-4 \
                or not np.isclose(g["loss"], lwant["loss"], rtol=1e-4, atol=0) or tuple(r["launches"]) != (n_val, 0):
            raise AssertionError(f"retina Learner validation at B=1, rank {r['rank']}: {g}, (K1, K2) {r['launches']} "
                                 f"vs one process {lwant}, ({n_val}, 0)")
    sp_launches["retina_learner_eval_b1"] = [(r["launches"],) for r in learned]
    numbers["a"]["retina_learner_eval_b1"] = {"metrics": lwant, "rank_s": [r["s"] for r in learned], "one_s": one_s,
                                              "batches": n_val, "one_process_launches": one_launches}
    log(f"spatial (a″) retina Learner validation at {SP_EVAL_B1}², B=1 ({n_val} batches; each spatial group gathers "
        f"its sample, rank 0 reports it) == one process: {lwant}; K1/K2 {learned[0]['launches']} per rank; "
        f"{[round(r['s'], 2) for r in learned]} s a rank vs one process {one_s:.2f} s on {smi}")
    numbers["a"]["child_s"], numbers["a"]["gloo_staged"] = t_a, staged
    log(f"spatial (a): torchrun child {t_a:.1f} s; gloo staging through host memory logged: {staged}")

    # (b) Grounder(mesh_spatial=2) on one card against the plain Grounder, float32.
    kernels = (fused_match_loss, fused_match_loss_backward, fused_bottleneck_infer)
    for k in kernels:
        k.launches = 0
    model_dir = run_dir / "models" / "smoke"
    f32 = {"compute_dtype": "float32"}
    one = Grounder.from_checkpoint(model_dir, batch_size=BATCH, cfg_overrides=f32, device=CUDA)
    sp = Grounder.from_checkpoint(model_dir, batch_size=BATCH, cfg_overrides=f32, devices=[CUDA, CUDA],
                                  mesh_spatial=2)
    val = pd.read_csv(tmp / "synthetic" / "csv_dir" / "val.csv")
    paths = [tmp / "synthetic" / "images" / str(p) for p in val["img_id"]][:BATCH]
    queries = [str(q) for q in val["query"]][:BATCH]
    errs, lat = {}, {}
    for n_req in (1, BATCH):
        got, want_r = sp.ground(paths[:n_req], queries[:n_req]), one.ground(paths[:n_req], queries[:n_req])
        anchors = (_spatial_anchors(sp, paths[:n_req], queries[:n_req]),
                   _best_anchors(one, paths[:n_req], queries[:n_req], one._pad_to(n_req)))
        errs[n_req] = _held_results(f"spatial Grounder bucket {n_req}", got, want_r, anchors)
        ms = {"spatial": [], "plain": []}
        for _ in range(3):
            for name, g in (("spatial", sp), ("plain", one), ("plain", one), ("spatial", sp)):
                t1 = time.perf_counter()
                g.ground(paths[:n_req], queries[:n_req])
                ms[name].append((time.perf_counter() - t1) * 1e3)
        lat[n_req] = {k: statistics.median(v) for k, v in ms.items()}
    sp.local_mesh.close()
    del sp
    # int8: both calibrate on the same first chunk through the unsharded
    # model; the members' convs take those scales by the global height.
    q_kw = dict(batch_size=2 * BATCH, bucket_sizes=(1, BATCH), cfg_overrides=f32, quantize=True)
    q_one = Grounder.from_checkpoint(model_dir, device=CUDA, **q_kw)
    q_sp = Grounder.from_checkpoint(model_dir, devices=[CUDA, CUDA], mesh_spatial=2, **q_kw)
    q_errs = {}
    for n_req in (BATCH, 1):
        got, want_r = q_sp.ground(paths[:n_req], queries[:n_req]), q_one.ground(paths[:n_req], queries[:n_req])
        anchors = (_spatial_anchors(q_sp, paths[:n_req], queries[:n_req]),
                   _best_anchors(q_one, paths[:n_req], queries[:n_req], q_one._pad_to(n_req)))
        q_errs[n_req] = _held_results(f"int8 spatial Grounder bucket {n_req}", got, want_r, anchors)
    scales = [quant_scales(m) for m, _ in q_sp.replicas]
    want_s = quant_scales(q_one.model)
    if any(sc.keys() != want_s.keys() or any(not torch.equal(sc[k], want_s[k]) for k in want_s) for sc in scales):
        raise AssertionError("the int8 spatial members' activation scales differ from the one-device Grounder's")
    q_sp.local_mesh.close()
    del q_one, q_sp
    numbers["b"] = {"score_err": errs, "ground_ms": lat, "int8_score_err": q_errs, "int8_scales": len(want_s)}
    # (b′) SSD-VGG16 (phase 9's checkpoint): the split VGG tower in the spatial Grounder, float32.
    ssd_dir = tmp / "ssd_run" / "models" / "ssd"
    s_one = Grounder.from_checkpoint(ssd_dir, batch_size=BATCH, cfg_overrides=f32, device=CUDA)
    s_sp = Grounder.from_checkpoint(ssd_dir, batch_size=BATCH, cfg_overrides=f32, devices=[CUDA, CUDA],
                                    mesh_spatial=2)
    if s_sp.cfg.mdl_to_use != "ssd_vgg":
        raise AssertionError(f"phase 9's checkpoint serves {s_sp.cfg.mdl_to_use}")
    ssd_errs, ssd_lat = {}, {}
    for n_req in (1, BATCH):
        got, want_r = s_sp.ground(paths[:n_req], queries[:n_req]), s_one.ground(paths[:n_req], queries[:n_req])
        anchors = (_spatial_anchors(s_sp, paths[:n_req], queries[:n_req]),
                   _best_anchors(s_one, paths[:n_req], queries[:n_req], s_one._pad_to(n_req)))
        ssd_errs[n_req] = _held_results(f"SSD spatial Grounder bucket {n_req}", got, want_r, anchors)
        ms = {"spatial": [], "plain": []}
        for _ in range(3):
            for name, g in (("spatial", s_sp), ("plain", s_one), ("plain", s_one), ("spatial", s_sp)):
                t1 = time.perf_counter()
                g.ground(paths[:n_req], queries[:n_req])
                ms[name].append((time.perf_counter() - t1) * 1e3)
        ssd_lat[n_req] = {k: statistics.median(v) for k, v in ms.items()}
    s_sp.local_mesh.close()
    del s_one, s_sp
    numbers["b′"] = {"score_err": ssd_errs, "ground_ms": ssd_lat}
    log(f"spatial (b′): Grounder(mesh_spatial=2) with SSD-VGG16 (phase 9's checkpoint, its VGG tower split by "
        f"height) == the plain Grounder in float32, buckets 1 and {BATCH}: max score differences {ssd_errs} "
        f"(scores and boxes 1e-4); ground ms in turns (medians) {ssd_lat} on {smi} — two members on one card, "
        "not a scaling figure")
    log(f"spatial (b): Grounder(mesh_spatial=2) on cuda:0 twice == the plain Grounder in float32, buckets 1 and "
        f"{BATCH}: max score differences {errs}; ground ms in turns (medians) {lat} on {smi} — two members on "
        f"one card, not a scaling figure; int8 (batch_size {2 * BATCH}, buckets {BATCH} then 1): == the "
        f"one-device int8 Grounder, max score differences {q_errs}, its {len(want_s)} activation scales equal "
        "on both members")

    # (c) The daemon: serve.py --mesh_spatial=2 as a process.
    daemon = _Daemon(model_dir, [f"--batch_size={BATCH}", "--mesh_spatial=2", f"--device={CUDA.type}",
                                 "--compute_dtype=float32"])
    try:
        code1, one_res, _, _ = _post(daemon.url, {"query": queries[1], "image_path": str(paths[1])})
        code2, many, _, _ = _post(daemon.url, {"requests": [{"query": q, "image_path": str(p)}
                                                            for p, q in zip(paths[2:5], queries[2:5])]})
        code3, multi, _, _ = _post(daemon.url, {"queries": queries[:4], "image_path": str(paths[0])})
    finally:
        tail = daemon.stop()
    rc = daemon.proc.returncode
    if (code1, code2, code3) != (200, 200, 200) or rc != 0 or "daemon stopped" not in tail:
        raise AssertionError(f"spatial daemon: statuses {code1}, {code2}, {code3}, exit {rc}:\n{tail[-3000:]}")
    got = [one_res, *many["results"], *multi["results"]]
    want_r = one.ground(paths[1:5] + [paths[0]] * 4, queries[1:5] + queries[:4])
    for i, (a, b) in enumerate(zip(got, want_r)):
        if abs(a["score"] - b["score"]) > 1e-4:
            raise AssertionError(f"spatial daemon request {i}: {a} vs the plain Grounder's {b}")
    _in_range("spatial daemon", got)
    numbers["c"] = {"max_score_err": max(abs(a["score"] - b["score"]) for a, b in zip(got, want_r))}
    launches = [k.launches for k in kernels]
    if any(launches[:2]) or launches[2]:
        raise AssertionError(f"spatial serving launched (K1, K2, K3) {launches}")
    shared = [ln for ln in tail.splitlines() if "the members share them" in ln]
    log(f"spatial (c): serve.py --mesh_spatial=2 ({shared[0] if shared else 'one member a device'}) answered the "
        f"pair, requests and queries forms ({len(got)} pairs) as the plain Grounder, max score difference "
        f"{numbers['c']['max_score_err']:.2e}; "
        f"(K1, K2, K3) launches in (b) {launches} (the daemon's own process launches none: it has no loss)")
    log(f"spatial phase passed in {time.perf_counter() - t_phase:.1f} s on {smi}; numbers {json.dumps(numbers)}")
    return launches, sp_launches


# ------------------------------------------------------------ phase 14

BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "int8_qps", "int8_vs_baseline", "grouped_q5_qps",
              "grouped_q5_vs_baseline", "grouped_q5_int8_qps", "grouped_q5_int8_vs_baseline")
BENCH_PATHS = ("value", "int8", "grouped_q5", "grouped_q5_int8")


def _kernel_counts() -> list[int]:
    """Launches of K1, K2 and K3 since their counts were last set to 0."""
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer

    return [*_counts(), fused_bottleneck_infer.launches]


def _zero_kernel_counts() -> None:
    from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import fused_bottleneck_infer

    _zero_counts()
    fused_bottleneck_infer.launches = 0


def _top_anchors(model, img: torch.Tensor, qvec: torch.Tensor, qlens: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(img, qvec, qlens)["att_out"].argmax(dim=-1)


def _held_boxes(name: str, got: tuple, want: tuple, anchors: tuple, tol: float = 1e-4) -> dict:
    """Scores within ``tol``, boxes within ``tol`` wherever both picked the
    same anchor, and that on at least half the rows."""
    same = anchors[0] == anchors[1]
    d_box = (got[0] - want[0]).abs().amax(dim=-1)
    d_score = float((got[1] - want[1]).abs().max())
    d_same = float(d_box[same].max()) if bool(same.any()) else float("nan")
    share = float(same.float().mean())
    if share < 0.5 or d_score > tol or not d_same <= tol:
        raise AssertionError(f"{name}: scores within {d_score:.3g}, boxes within {d_same:.3g} on the {share:.1%} "
                             f"of rows with the same anchor (tolerance {tol})")
    log(f"headline: {name}: scores within {d_score:.3g}, boxes within {d_same:.3g} on the {share:.1%} of "
        f"{same.numel()} rows with the same anchor")
    return {"score_max_abs_err": d_score, "box_max_abs_err": d_same, "same_anchor_share": share}


def check_headline(smi: str) -> tuple[list[int], dict]:
    """Phase 14, the headline benchmark's protocol on the card. ``bench.run``
    at full width and the full protocol (B = 128, 3 + 100 calls on each of
    bf16, int8, grouped 26 × 5 and grouped int8) with K1, K2 and K3 at 0
    launches; the bench's flat bf16 boxes against ``Grounder._infer`` on the
    same model and batch, and its grouped path against the flat path on each
    image tiled 5 times in float32 (scores within 1e-4, boxes within 1e-4
    where the anchor is the same); the share of int8 boxes with IoU ≥ 0.5
    against bf16. Then each measurement tool once at its default size:
    ``profile_bench`` (B = 64), ``bench_infer_ab`` (B = 128), no
    K1/K2/K3 launch; ``bench_grouped_train`` (60 pairs, Q = 5) and
    ``profile_train_step`` (B = 128, traced), K1 and K2 once a step. Returns
    the bench's (K1, K2, K3) launches and the numbers."""
    from zsgnet_tpu_torch import bench
    from zsgnet_tpu_torch.data.vocab import Vocab
    from zsgnet_tpu_torch.models.quant import set_quant_mode
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet
    from zsgnet_tpu_torch.predict import Grounder
    from zsgnet_tpu_torch.tools import bench_grouped_train, bench_infer_ab, profile_bench, profile_train_step

    t_phase = time.perf_counter()
    _zero_kernel_counts()
    report: dict = {}
    t0 = time.perf_counter()
    row = bench.run(device="cuda", report=report)
    launches = _kernel_counts()
    t_run = time.perf_counter() - t0
    if any(launches):
        raise AssertionError(f"the headline bench launched (K1, K2, K3) {launches} times")
    if tuple(row) != BENCH_KEYS or row["metric"] != "grounding_queries_per_sec_per_chip" or not all(
            isinstance(row[k], float) and np.isfinite(row[k]) and row[k] > 0 for k in BENCH_KEYS if k not in (
                "metric", "unit")):
        raise AssertionError(f"headline row {row}")
    log(f"headline: bench.run in {t_run:.1f} s on {smi}; K1, K2, K3 launches {launches}; its row:")
    log(json.dumps(row))
    numbers: dict = {"row": row, "seconds": t_run, "paths": {
        k: {x: report[k][x] for x in ("qps", "wall_ms", "device_ms", "launches", "idle", "peak_bytes")}
        for k in BENCH_PATHS}}
    for k in BENCH_PATHS:
        box, score = report[k]["out"]
        if not (torch.isfinite(box).all() and torch.isfinite(score).all() and box.abs().max() <= 1.0):
            raise AssertionError(f"headline {k}: boxes or scores out of range")

    model, anchors, flat, grouped = report["model"], report["anchors"], report["flat"], report["grouped"]
    set_quant_mode(model, "off")
    g = Grounder(model.cfg.replace(quant_mode="off"), Vocab({f"w{i}": i for i in range(bench.VOCAB)}),
                 model.state_dict(), batch_size=bench.BATCH, device="cuda")
    if g.quantize or g.cfg.head_canvas or g.canvas_for(bench.BATCH) is not None:
        raise AssertionError("the B = 128 Grounder does not serve bf16 through the per-level head")
    box, score = report["value"]["out"]
    with torch.inference_mode():
        want = g._infer(flat["img"], flat["qvec"], flat["qlens"])
    numbers["vs_grounder"] = _held_boxes(
        "bf16 bench vs Grounder._infer", (box, torch.sigmoid(score)), want,
        (_top_anchors(model, flat["img"], flat["qvec"], flat["qlens"]),
         _top_anchors(g.model, flat["img"], flat["qvec"], flat["qlens"])))
    del g

    f32 = ZSGNet(model.cfg.replace(compute_dtype="float32", quant_mode="off"), bench.VOCAB)
    f32.load_state_dict({k: v for k, v in model.state_dict().items() if "_absmax_" not in k})
    f32 = f32.to(CUDA).eval()
    n, q = grouped["qvec"].shape[:2]
    tiled = (grouped["img"].repeat_interleave(q, dim=0), grouped["qvec"].reshape(n * q, -1),
             grouped["qlens"].reshape(n * q))
    numbers["grouped_vs_tiled_f32"] = _held_boxes(
        "float32 grouped vs each image tiled 5 times",
        bench.infer(f32, anchors, grouped["img"], grouped["qvec"], grouped["qlens"]),
        bench.infer(f32, anchors, *tiled),
        (_top_anchors(f32, grouped["img"], grouped["qvec"], grouped["qlens"]), _top_anchors(f32, *tiled)))
    del f32

    iou = _iou(report["int8"]["out"][0].cpu().numpy(), report["value"]["out"][0].cpu().numpy())
    numbers["int8_iou_ge_0.5_share"] = float((iou >= 0.5).mean())
    log(f"headline: int8 vs bf16 boxes on {len(iou)} pairs: IoU >= 0.5 for {numbers['int8_iou_ge_0.5_share']:.1%}, "
        f"median IoU {float(np.median(iou)):.4f}")
    del report, model

    tools: dict = {}
    for name, fn, train in (
            ("profile_bench", lambda: profile_bench.bench(device="cuda"), False),
            ("bench_infer_ab", lambda: bench_infer_ab.bench(device="cuda"), False),
            ("bench_grouped_train", lambda: bench_grouped_train.bench(device="cuda"), True),
            ("profile_train_step", lambda: profile_train_step.bench(device="cuda"), True)):
        _zero_kernel_counts()
        t0 = time.perf_counter()
        res = fn()
        k1, k2, k3 = _kernel_counts()
        if not (k3 == 0 and (k1 == k2 > 0 if train else k1 == k2 == 0)):
            raise AssertionError(f"{name} launched (K1, K2, K3) {(k1, k2, k3)} times")
        if name == "profile_train_step":
            res = {**res, "top": [(k[:80], t, c) for k, t, c in res["top"][:10]]}
        tools[name] = {**res, "seconds": time.perf_counter() - t0, "kernel_launches": [k1, k2, k3]}
        log(f"headline: {name} in {tools[name]['seconds']:.1f} s on {smi}, (K1, K2, K3) launches {[k1, k2, k3]}; "
            f"{json.dumps(res, default=str)}")
        torch.cuda.empty_cache()
    steps = 3 * (bench_grouped_train.WARMUP + bench_grouped_train.ITERS)
    if tools["bench_grouped_train"]["kernel_launches"][0] != steps:
        raise AssertionError(f"bench_grouped_train: K1 {tools['bench_grouped_train']['kernel_launches'][0]} times, "
                             f"not once in each of {steps} steps")
    numbers["tools"] = tools
    log(f"headline phase passed in {time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches, numbers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # Phase 2: build the kernels from the checkout's sources.
    from zsgnet_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.load_all(["fused_loss", "fused_bottleneck"])
    log(f"built fused_loss and fused_bottleneck in parallel in {time.perf_counter() - t0:.2f} s")
    from zsgnet_tpu_torch.data import native

    t0 = time.perf_counter()
    log(f"native image library: {native.status()} in {time.perf_counter() - t0:.2f} s (g++ on this host)")

    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import BatchLoader, ImgQuDataset
    from zsgnet_tpu_torch.data.synthetic import generate
    from zsgnet_tpu_torch.data.vocab import Vocab
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.ops import anchors as anchor_ops, losses
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss, fused_match_loss_backward
    from zsgnet_tpu_torch.parallel.train_step import make_compute_loss, make_eval_step, to_device
    from zsgnet_tpu_torch.predict import Grounder
    from zsgnet_tpu_torch.train.evaluator import Evaluator

    cfg = get_default_cfg().replace(use_level_path=False, bs=BATCH)
    anchors = anchor_pyramid_for(cfg)

    # Phase 3: the kernels against their plain versions, at the main path's shapes.
    k1 = check_fused_loss(anchors)
    k2 = check_fused_loss_backward(anchors)
    loss_timings(k1, k2)
    check_small_against_cpu()

    with tempfile.TemporaryDirectory() as tmp:
        root = generate(tmp, n_train=N_TRAIN, n_val=40, n_test=16, img_size=300, seed=SEED)
        vocab = Vocab.build(pd.read_csv(root / "csv_dir" / "train.csv")["query"].astype(str))
        val = ImgQuDataset(root / "csv_dir" / "val.csv", root / "images", vocab, cfg)
        batches = list(BatchLoader(val, BATCH, shuffle=False, drop_last=False))
        model = get_default_net(cfg, len(vocab), seed=SEED, device="cuda")
        log(f"config: {cfg.resize_img} fpn {cfg.fpn_ch} head {cfg.head_ch} emb {cfg.emb_dim} "
            f"lstm {cfg.lstm_dim} anchors/cell {cfg.num_anchors} A={anchors.shape[0]} "
            f"{cfg.compute_dtype}; {len(val)} val rows in {len(batches)} batches of {BATCH}")

        # The kernel's loss against the eager oracle on real model outputs.
        with torch.inference_mode():
            b0 = to_device(batches[-1], torch.device("cuda"))
            out = model(b0["img"], b0["qvec"], b0["qlens"])
            w0 = b0["valid"].float()
            annot = b0["annot"].float()
            fused = make_compute_loss(cfg, anchors, "cuda")(out, annot, sample_weight=w0)
            labels, reg_t = anchor_ops.match_and_encode(
                torch.as_tensor(anchors, device="cuda"), annot)
            plain = losses.zsg_loss(out["att_out"], out["bbx_out"], labels, reg_t,
                                    sample_weight=w0)
        if tuple(out["att_out"].shape) != (BATCH, anchors.shape[0]) or tuple(
                out["bbx_out"].shape) != (BATCH, anchors.shape[0], 4):
            raise AssertionError(f"output shapes {out['att_out'].shape} {out['bbx_out'].shape}")
        if not torch.allclose(fused["total"], plain["total"], rtol=1e-4):
            raise AssertionError(f"fused loss {fused['total']} != plain {plain['total']}")
        log(f"eval loss (kernel) {float(fused['total']):.6f} == plain {float(plain['total']):.6f}")

        # Phase 4: evaluation; the counts are read right after.
        step = make_eval_step(cfg, anchors, device="cuda")
        evaluator = Evaluator(cfg.acc_iou_threshold)
        fused_match_loss.launches = fused_match_loss_backward.launches = 0
        times = []
        for epoch in range(3):
            evaluator.reset()
            for batch in batches:
                t0 = time.perf_counter()
                ev = step(model, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if not torch.isfinite(ev["loss"]).all():
                    raise AssertionError("non-finite eval loss")
                evaluator.update(ev, batch["case"], batch["idxs"], batch["valid"])
        eval_launches = (fused_match_loss.launches, fused_match_loss_backward.launches)
        summary = evaluator.summarize()
        if not {"Acc", "MaxPos", "loss"} <= set(summary) or summary["num_samples"] != len(val):
            raise AssertionError(f"evaluator summary {summary}")
        if eval_launches != (3 * len(batches), 0):
            raise AssertionError(f"the eval path launched (K1, K2) {eval_launches} times")
        steady = times[len(batches):]
        log(f"eval: {summary}")
        log(f"eval step B={BATCH}: median {statistics.median(steady):.3f} ms/batch over "
            f"{len(steady)} warm batches (first epoch {times[:len(batches)]}); "
            f"K1 launches {eval_launches[0]}")
        kernels = device_kernels(lambda: step(model, batches[0]), 5)
        busy = sum(t for _, t, _ in kernels)
        log(f"eval step device time {busy:.3f} ms/batch in {sum(n for *_, n in kernels)} "
            f"kernel launches (idle {1 - busy / statistics.median(steady):.1%} of the median "
            f"step); top: {[(k[:60], round(t, 4), n) for k, t, n in kernels[:8]]}")

        # Phase 5: grounding, 1 request then 16, on the synthetic images.
        grounder = Grounder(cfg, vocab, model.state_dict(), batch_size=BATCH, device="cuda")
        paths = [root / "images" / str(p) for p in val.df["img_id"][:BATCH]]
        queries = val.queries()[:BATCH]
        grounder.ground(paths, queries)  # warm-up
        for n in (1, BATCH):
            lat = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = grounder.ground(paths[:n], queries[:n])
                lat.append((time.perf_counter() - t0) * 1e3)
            boxes = np.array([r["box_norm"] for r in res])
            if len(res) != n or not np.isfinite(boxes).all() or np.abs(boxes).max() > 1.0:
                raise AssertionError(f"grounding {n} requests gave {res}")
            log(f"ground {n} request(s): median {statistics.median(lat):.3f} ms "
                f"(runs {[round(x, 3) for x in lat]}); first {res[0]}")
        del model, grounder

        # Phase 6: training.
        k1["launches"], k2["launches"] = check_training(tmp, str(Path(tmp) / "run"))

        # Phase 8: serving the checkpoint phase 6 wrote.
        serving_launches = check_serving(Path(tmp) / "run" / "models" / "smoke", root, smi)

        # Phase 9: grouped multi-query training, SSD-VGG, remat.
        check_variants(tmp, Path(tmp), k1, k2)

        # Phase 7: K3 on layer1.
        k3 = check_bottleneck()

        # Phase 11: the host data path and the tools, on phase 6's data and
        # checkpoint; after phase 7, whose bench needs the profiler's device
        # events, and before phase 10.
        host_launches = check_host_data(Path(tmp), Path(tmp) / "run", smi)

        # Phase 12: data parallel (torchrun NCCL at world 1, two gloo ranks
        # sharing the card, data-parallel serving), after phase 11.
        dp_launches, dp_kernel_launches = check_data_parallel(Path(tmp), Path(tmp) / "run", smi)

        # Phase 13: spatial partitioning (two gloo ranks sharing the card:
        # retina and SSD-VGG16 at 600² and 300², SSD-VGG16 and the retina
        # Learner's validation at B = 1; the spatial Grounder with retina and
        # SSD-VGG16, the spatial daemon), after phase 12 and before phase 10.
        sp_serving_launches, sp_kernel_launches = check_spatial(Path(tmp), Path(tmp) / "run", smi)

        # Phase 14: the headline benchmark's protocol (bench.run at B = 128,
        # held against the Grounder and the tiled flat path) and the
        # measurement tools, after phase 13 and before phase 10.
        headline_launches, headline = check_headline(smi)

        # Phase 10, last: the serving formats (canvas head, int8, exported
        # artifacts) on phase 6's checkpoint. Its many profiler windows and
        # exports left the profiler without device events for phase 7's
        # bench when it ran before it.
        formats_launches = check_serving_formats(Path(tmp) / "run" / "models" / "smoke", root, smi)
    for i, (k, n, f, h, d, sps, hb) in enumerate(zip((k1, k2, k3), serving_launches, formats_launches, host_launches,
                                                     dp_launches, sp_serving_launches, headline_launches)):
        k["serving_launches"], k["serving_formats_launches"], k["host_data_launches"] = n, f, h
        k["data_parallel_serving_launches"], k["spatial_serving_launches"] = d, sps
        k["headline_bench_launches"] = hb
        k["measurement_tools_launches"] = {name: t["kernel_launches"][i] for name, t in headline["tools"].items()}
    for i, k in enumerate((k1, k2)):
        k["data_parallel_launches"] = {"nccl_world1": dp_kernel_launches["nccl_world1"][i],
                                       "gloo_world2_per_rank": [r[i] for r in dp_kernel_launches["gloo_per_rank"]]}
        k["spatial_launches_per_rank"] = {
            f"{mdl}_{res}x{res}_B{bs}_{steps}_steps_1_eval_batch": {
                "steps": [st[i] for st, _ in sp_kernel_launches[_sp_tag(mdl, res, bs)]],
                "eval_batch": [evl[i] for _, evl in sp_kernel_launches[_sp_tag(mdl, res, bs)]]}
            for mdl, res, bs, steps in SP_CASES}
        k["spatial_launches_per_rank"][f"retina_learner_validation_{SP_EVAL_B1}x{SP_EVAL_B1}_B1"] = {
            "eval_batches": [ev[i] for (ev,) in sp_kernel_launches["retina_learner_eval_b1"]]}
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s, the kernels' build included")

    print(smi, flush=True)
    print(json.dumps({"kernels": [k1, k2, k3]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(sp_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
