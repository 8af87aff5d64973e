"""Kernel K3 against its plain version and the eager cuDNN block, on the
card, at the ResNet-50 layer1 shape.

    python -m zsgnet_tpu_torch.tools.bench_bottleneck [B]

Counterpart of ``tools/bench_bottleneck.py`` (default B = 128 as there).
Seeded numpy inputs at [B, 75, 75, 256] bf16, Cmid 64: the identity block
of layer1, and its projection block 0 ([B, 75, 75, 64] → 256). For each,
K3 must equal the plain version within max |diff| / max |plain| < 0.05 (the
JAX tool's own test), as must the port's eager ``Bottleneck`` holding the
same weights. Then CUDA events time 50 calls each of K3, the plain version,
and the eager block in eval mode under bf16 autocast (the cuDNN route the
model takes) in NCHW and in ``channels_last``. The identity calls are
chained, each taking the last one's output; the projection changes the
width, so its calls repeat on one input. Beside K3 as the package calls it
(``k3_ms``, the kernel that the shape selects, named in ``k3_kernel``) the
same run times each kernel of the source on the same inputs, in turns:
the ``mma.sync`` kernel (``k3_mma_ms``) and the Hopper kernel with 8 × 8 and
8 × 16 output tiles (``k3_wgmma8x8_ms``, ``k3_wgmma8x16_ms``), each checked
against the plain version first. Each ``*_ms`` is CUDA events around
back-to-back calls, which the host's time per call bounds from below when
the kernel is shorter than that; each ``*_device_ms`` is the kernel's own
time on the card per launch, from ``torch.profiler``. ``prologue_device_ms``
is the Hopper kernel's weight prologue alone (its grid launched over no
tile). Prints one JSON
object per block after the card's name and power limit; ``bench`` returns
the same dict.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys

import numpy as np
import torch

from zsgnet_tpu_torch.models.resnet import Bottleneck
from zsgnet_tpu_torch.ops.cuda.fused_bottleneck import (
    bottleneck_infer_reference,
    fused_bottleneck_infer,
    kernel_for,
    launch_variant,
)
from zsgnet_tpu_torch.utils.backend import resolve_device

H = W = 75
CMID = 64
COUT = 256


def random_args(rng: np.random.Generator, cin: int, cmid: int, cout: int, proj: bool,
                device: str | torch.device) -> dict[str, torch.Tensor]:
    """Seeded float32 kernel arguments: LeCun-normal weights, folded scales
    in [0.8, 1.2], biases N(0, 0.1²); the projection's when ``proj``."""
    def w(*shape, fan_in):
        return rng.normal(size=shape) / np.sqrt(fan_in)

    def s(n):
        return rng.uniform(0.8, 1.2, size=n)

    def b(n):
        return rng.normal(0.0, 0.1, size=n)

    args = dict(w1=w(cin, cmid, fan_in=cin), s1=s(cmid), b1=b(cmid),
                w2=w(3, 3, cmid, cmid, fan_in=9 * cmid), s2=s(cmid), b2=b(cmid),
                w3=w(cmid, cout, fan_in=cmid), s3=s(cout), b3=b(cout))
    if proj:
        args.update(wd=w(cin, cout, fan_in=cin), sd=s(cout), bd=b(cout))
    return {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in args.items()}


def eager_block(args: dict[str, torch.Tensor]) -> Bottleneck:
    """The port's eval-mode ``Bottleneck`` computing the same block: each
    BatchNorm holds (weight s, bias b, mean 0, var 1 − eps)."""
    cin, cmid = args["w1"].shape
    block = Bottleneck(cin, cmid).to(args["w1"].device).eval()
    one = lambda t: t.t()[:, :, None, None]  # noqa: E731  (I, O) → (O, I, 1, 1)
    bns = [(block.bn1, "1"), (block.bn2, "2"), (block.bn3, "3")]
    with torch.no_grad():
        block.conv1.weight.copy_(one(args["w1"]))
        block.conv2.weight.copy_(args["w2"].permute(3, 2, 0, 1))
        block.conv3.weight.copy_(one(args["w3"]))
        if "wd" in args:
            block.downsample[0].weight.copy_(one(args["wd"]))
            bns.append((block.downsample[1], "d"))
        for bn, k in bns:
            bn.weight.copy_(args[f"s{k}"])
            bn.bias.copy_(args[f"b{k}"])
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0 - bn.eps)
    return block


def _ms(fn, x: torch.Tensor, iters: int, chain: bool) -> float:
    """Mean device time per call over ``iters`` calls (CUDA events)."""
    y = x
    for _ in range(3):
        y = fn(y if chain else x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        y = fn(y if chain else x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, x: torch.Tensor, iters: int, chain: bool) -> float:
    """Mean time on the device of the K3 kernel that ``fn`` launches, per
    launch, from ``torch.profiler``'s CUDA activity: what the card spends,
    whatever the host takes to get to the next launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    y = fn(x)
    torch.cuda.synchronize()
    rows = []
    for _ in range(3):  # the profiler now and then returns a window without its device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                y = fn(y if chain else x)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "bottleneck_" in e.key and "_kernel" in e.key]
        if len(rows) == 1 and rows[0].count > 0:
            return rows[0].self_device_time_total / 1e3 / rows[0].count
    raise AssertionError(f"expected one K3 kernel in the profile, found {[(e.key, e.count) for e in rows]}")


def _rel(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    d = float((got.float() - want.float()).abs().max())
    return d, d / max(float(want.float().abs().max()), 1e-6)


def bench(b: int = 128, device: str | torch.device = "cuda", *, proj: bool = False,
          iters: int = 50, seed: int = 0) -> dict:
    """Check and time one layer1 block at batch ``b`` on ``device`` (CUDA
    only: the timings are the card's). ``proj`` takes block 0 (64 → 256)
    instead of an identity block (256 → 256)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"bench_bottleneck times a CUDA device, not {dev}")
    cin = CMID if proj else COUT
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, H, W, cin)).astype(np.float32)).to(dev).to(torch.bfloat16)
    args = random_args(rng, cin, CMID, COUT, proj, dev)
    block = eager_block(args)
    block_cl = copy.deepcopy(block).to(memory_format=torch.channels_last)

    def fused(t):
        return fused_bottleneck_infer(t, **args)

    def plain(t):
        return bottleneck_infer_reference(t, **args)

    def eager(blk):
        def run(t):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return blk(t)
        return run

    with torch.inference_mode():
        want = plain(x)
        got = fused(x)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        x_cl = x_nchw.contiguous(memory_format=torch.channels_last)
        ref_eager = eager(block)(x_nchw).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        diff, rel = _rel(got, want)
        eager_diff, eager_rel = _rel(ref_eager, want)
        if not rel < 0.05:
            raise AssertionError(f"K3 diverges from its plain version: max|diff| {diff}, relative {rel}")
        if not eager_rel < 0.05:
            raise AssertionError(f"the eager block diverges from the plain version: relative {eager_rel}")
        chain = not proj
        selected = kernel_for(cin, CMID, COUT, proj)
        by_kernel = {}
        for name in ("mma", "wgmma8x8", "wgmma8x16"):
            y = launch_variant(name, x, **args)
            torch.cuda.synchronize()
            if not _rel(y, want)[1] < 0.05:
                raise AssertionError(f"K3's {name} kernel diverges from its plain version: {_rel(y, want)}")
        # In turns, so that no kernel alone meets a warmer or a throttled card.
        for name in ("mma", "wgmma8x8", "wgmma8x16", "wgmma8x16", "wgmma8x8", "mma"):
            t = _ms(lambda t, name=name: launch_variant(name, t, **args), x, iters, chain)
            by_kernel[name] = min(by_kernel.get(name, t), t)
        device = {name: _device_ms(lambda t, name=name: launch_variant(name, t, **args), x, 20, chain)
                  for name in by_kernel}
        times = {
            "k3_ms": _ms(fused, x, iters, chain),
            "k3_kernel": selected,
            "k3_device_ms": device[selected],
            **{f"k3_{name}_ms": t for name, t in by_kernel.items()},
            **{f"k3_{name}_device_ms": t for name, t in device.items()},
            "prologue_device_ms": _device_ms(
                lambda t: launch_variant(selected, t, **args, prologue_only=True), x, 20, False),
            "plain_ms": _ms(plain, x, iters, chain),
            "eager_nchw_ms": _ms(eager(block), x_nchw, iters, chain),
            "eager_channels_last_ms": _ms(eager(block_cl), x_cl, iters, chain),
        }
    n_bytes = x.numel() * x.element_size() + got.numel() * got.element_size() + sum(
        t.numel() * t.element_size() for t in args.values())
    flops = 2 * b * H * W * (cin * CMID + 9 * CMID * CMID + CMID * COUT + (cin * COUT if proj else 0))
    return {
        "block": "projection" if proj else "identity", "shape": [b, H, W, cin], "cmid": CMID,
        "cout": COUT, "max_abs_diff": diff, "scale": float(want.float().abs().max()),
        "rel_diff": rel, "eager_rel_diff": eager_rel, **times, "chained": chain, "iters": iters,
        "bytes": n_bytes, "flops": flops, "device": torch.cuda.get_device_name(dev),
    }


def main(argv: list[str]) -> int:
    b = int(argv[0]) if argv else 128
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's float32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for proj in (False, True):
        print(json.dumps(bench(b, proj=proj)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
