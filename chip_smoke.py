"""Smoke run of zsgnet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds the package's CUDA kernel from ``zsgnet_tpu_torch/csrc`` with nvcc,
holds it against its plain PyTorch version, then drives the main path at
the full width of the default retina model at 300² (ResNet-50 + FPN 256,
head 256, embedding 300, BiLSTM 256, 9 anchors, bf16 convolutions) with
seeded random weights: the evaluation step over the validation split of a
synthetic dataset, and a ``Grounder`` answering 1 and then 16 requests.
Every phase is fatal on failure. The next-to-last line of standard output
is a JSON object describing each kernel; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import pandas as pd
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # float32 outside the tensor cores
# Float operations per (row, anchor) in csrc/fused_loss.cu's loop body,
# counting each transcendental (exp, log1p, pow, log) as one: IoU 17,
# labels 3, focal 30, targets 16, smooth-L1 and the sums 30.
K1_OPS_PER_ELEMENT = 96
BATCH = 16
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters: int) -> list[tuple[str, float, int]]:
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
    rows = [
        (e.key, getattr(e, "self_device_time_total", 0.0) / 1e3 / iters, e.count // iters)
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ]
    return sorted(rows, key=lambda r: -r[1])


def k1_inputs(anchors_cthw: np.ndarray, b: int, rng: np.random.Generator):
    """Seeded K1 inputs: random logits/deltas/boxes, weights of zeros and
    ones, and a zero-extent gt in row 1, whose IoU is 0 at every anchor."""
    a = anchors_cthw.shape[0]
    att = rng.normal(size=(b, a)).astype(np.float32) * 2
    bbx = rng.normal(size=(b, a, 4)).astype(np.float32)
    lo = rng.uniform(-1, 0.6, size=(b, 2))
    gt = np.concatenate([lo, lo + rng.uniform(0.05, 0.8, size=(b, 2))], axis=1).astype(np.float32)
    gt[1] = (0.25, -0.5, 0.25, -0.5)
    w = (rng.uniform(size=b) > 0.25).astype(np.float32)
    w[0] = w[1] = 1.0
    return att, bbx, gt, w


def check_fused_loss(anchors_cthw: np.ndarray) -> dict:
    """Phase 3: K1 against its plain version on the card, then timings."""
    from zsgnet_tpu_torch.ops.cuda import fused_loss as fl

    dev = torch.device("cuda")
    att, bbx, gt, w = (torch.from_numpy(x).to(dev) for x in k1_inputs(
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

    b, a = att.shape
    call = lambda: fl.fused_match_loss(att, bbx, *anc, gt, w)  # noqa: E731
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: fl.fused_match_loss_reference(att, bbx, *anc, gt, w))
    kernels = device_kernels(call, 20)
    device_ms = sum(t for _, t, _ in kernels)
    n_bytes = b * a * (4 + 16) + a * 32 + b * (16 + 4) + 3 * 4
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = b * a * K1_OPS_PER_ELEMENT / H100_F32_OPS_PER_S * 1e3
    log(f"K1 B={b} A={a}: {ms:.4f} ms per call back to back, device {device_ms:.4f} ms "
        f"({[(k, round(t, 5), n) for k, t, n in kernels]}), plain {plain_ms:.4f} ms, "
        f"bound {max(bytes_ms, ops_ms) * 1e3:.3f} us")
    return {
        "name": "fused_match_loss_fwd",
        "route": "cuda",
        "source": "zsgnet_tpu_torch/csrc/fused_loss.cu",
        "replaces": "zsgnet_tpu/ops/pallas/fused_loss.py:151",
        "launches": 0,
        "max_abs_err": float((got_c - want_c).abs().max()),
        "ms": ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def check_small_against_cpu() -> None:
    """The port on the card against the port on the CPU at a small float32
    size (the CPU path is held against the JAX package by the tests)."""
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.parallel.train_step import make_eval_step

    cfg = Config(resize_img=(64, 64), max_qlen=8, lstm_dim=8, emb_dim=8, fpn_ch=16,
                 head_ch=16, compute_dtype="float32", use_level_path=False)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
    build.load("fused_loss")
    log(f"built fused_loss in {time.perf_counter() - t0:.2f} s")

    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.data.dataset import EvalLoader, ImgQuDataset
    from zsgnet_tpu_torch.data.synthetic import generate
    from zsgnet_tpu_torch.data.vocab import Vocab
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.ops import anchors as anchor_ops, losses
    from zsgnet_tpu_torch.ops.cuda.fused_loss import fused_match_loss
    from zsgnet_tpu_torch.parallel.train_step import make_compute_loss, make_eval_step, to_device
    from zsgnet_tpu_torch.predict import Grounder
    from zsgnet_tpu_torch.train.evaluator import Evaluator

    cfg = get_default_cfg().replace(use_level_path=False, bs=BATCH)
    anchors = anchor_pyramid_for(cfg)

    # Phase 3: the kernel against its plain version, at the main path's shapes.
    k1 = check_fused_loss(anchors)
    check_small_against_cpu()

    with tempfile.TemporaryDirectory() as tmp:
        root = generate(tmp, n_train=16, n_val=40, n_test=0, img_size=300, seed=SEED)
        vocab = Vocab.build(pd.read_csv(root / "csv_dir" / "train.csv")["query"].astype(str))
        val = ImgQuDataset(root / "csv_dir" / "val.csv", root / "images", vocab, cfg)
        batches = list(EvalLoader(val, BATCH))
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

        # Phase 4: evaluation, the main path; the counts are read right after.
        step = make_eval_step(cfg, anchors, device="cuda")
        evaluator = Evaluator(cfg.acc_iou_threshold)
        fused_match_loss.launches = 0
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
        k1["launches"] = fused_match_loss.launches
        summary = evaluator.summarize()
        if not {"Acc", "MaxPos", "loss"} <= set(summary) or summary["num_samples"] != len(val):
            raise AssertionError(f"evaluator summary {summary}")
        if k1["launches"] == 0:
            raise AssertionError("the eval path never launched the fused loss kernel")
        steady = times[len(batches):]
        log(f"eval: {summary}")
        log(f"eval step B={BATCH}: median {statistics.median(steady):.3f} ms/batch over "
            f"{len(steady)} warm batches (first epoch {times[:len(batches)]}); "
            f"K1 launches {k1['launches']}")
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

    print(smi, flush=True)
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
