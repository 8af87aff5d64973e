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
and last layer1 of the same model through the fused inference bottleneck
(K3) against the eager layer1, with K3's timings from
``zsgnet_tpu_torch.tools.bench_bottleneck`` (the Hopper kernel beside the
``mma.sync`` kernel, same inputs, same run). The loss kernels K1 and K2
are checked on random inputs, on rows whose positives hang on the argmax
anchor and on non-finite deltas, and timed side by side through
``zsgnet_tpu_torch.tools.bench_loss``. Each path is driven with the kernels' launch counts set to 0 just before
it and read just after. Every phase is fatal on failure. The
next-to-last line of standard output is a JSON object describing each
kernel; the last is ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pandas as pd
import torch

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


def device_kernels(fn, iters: int) -> list[tuple[str, float, float]]:
    """(kernel name, device ms per call, launches per call) of ``fn``, from
    torch.profiler's CUDA activity, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # User annotations on the device timeline (Optimizer.step#Adam.step)
    # span kernels that are counted on their own; they carry the name of
    # their host-side range, which no kernel has.
    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type == DeviceType.CPU}
    rows = [
        (e.key, getattr(e, "self_device_time_total", 0.0) / 1e3 / iters, e.count / iters)
        for e in events
        if e.device_type == DeviceType.CUDA and e.key not in host_names
    ]
    return sorted(rows, key=lambda r: -r[1])


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

    def bound(n_bytes: int, ops: int) -> tuple[float, str]:
        bytes_ms, ops_ms = n_bytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    k1["bound_ms"], k1["bound_by"] = bound(r["k1_bytes"], b * a * K1_OPS_PER_ELEMENT)
    k2["bound_ms"], k2["bound_by"] = bound(r["k2_bytes"], b * a * K2_OPS_PER_ELEMENT + r["positives"] * K2_OPS_PER_POSITIVE)
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

    # Phase 7: K3, this slice's path.
    k3 = check_bottleneck()
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s, the kernels' build included")

    print(smi, flush=True)
    print(json.dumps({"kernels": [k1, k2, k3]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
