"""Kernels K1 and K2 of the fused loss against their plain versions on the
card, at the main path's shapes, and timed side by side.

    python -m zsgnet_tpu_torch.tools.bench_loss [B] [retina|ssd_vgg]

Seeded inputs at the default 300² pyramid of the retina model (A = 17451)
or of SSD-VGG (A = 17460) and batch B (default 16, the training batch; 120
is the grouped preset's 24 images × 5 phrases): logits N(0, 4), deltas
N(0, 1), random gt boxes with one of zero extent (its IoU ties at 0), row
weights of zeros and ones. K1 (``fused_match_loss``) must give its plain version's
``num_pos`` exactly and its sums to rtol 1e-4; each kernel of K2
(``BWD_VARIANTS``: the one the wrapper launches, the same with other row
groups, and the elementwise kernel), on K1's argmax anchors and the
upstream gradient of the mean loss, must give its plain version's
gradients to atol 1e-6. Then, on the same inputs, ``*_ms`` is CUDA events
around back-to-back calls (bounded from below by the host's time per call
when the kernel is shorter) and ``*_device_ms`` the kernel's own time on
the card per launch from ``torch.profiler``; K2's kernels are timed in
turns. ``k2_ms`` and ``k2_device_ms`` are K2 as the package calls it.
``k1_bytes`` and ``k2_bytes`` are what each function must move (each
input read once, each output written once; K2 reads the delta and the
anchor's cthw at positive anchors only, and ``positives`` counts them);
``k2_bytes_every_anchor`` counts them at every anchor. Prints the card's
name and power limit, then one JSON object; ``bench`` returns the same dict.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from zsgnet_tpu_torch.ops.cuda import fused_loss as fl
from zsgnet_tpu_torch.utils.backend import resolve_device

MATCH = (0.5, 0.4, 0.25, 2.0)  # match_thr, neg_thr, alpha, gamma of the default config


def random_inputs(anchors_cthw: np.ndarray, b: int, rng: np.random.Generator):
    """Seeded K1/K2 inputs: random logits/deltas/boxes, weights of zeros and
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


def _ms(fn, iters: int) -> float:
    """Mean time per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> float:
    """Time on the card per launch of the one kernel that ``fn`` launches,
    from ``torch.profiler``'s CUDA activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(3):  # the profiler now and then returns a window without its device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if len(rows) == 1 and rows[0].count > 0:
            return rows[0].self_device_time_total / 1e3 / rows[0].count
    raise AssertionError(f"expected one kernel in the profile, found {[(e.key, e.count) for e in rows]}")


def bench(b: int = 16, device: str | torch.device = "cuda", *, iters: int = 50, seed: int = 0,
          mdl_to_use: str = "retina") -> dict:
    """Check and time K1 and K2's kernels at batch ``b`` over the 300²
    anchors of ``mdl_to_use`` on ``device`` (CUDA only: the timings are the
    card's)."""
    from zsgnet_tpu_torch.config import get_default_cfg
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"bench_loss times a CUDA device, not {dev}")
    anchors = anchor_pyramid_for(get_default_cfg().replace(mdl_to_use=mdl_to_use))
    att, bbx, gt, w = (torch.from_numpy(x).to(dev) for x in random_inputs(anchors, b, np.random.default_rng(seed)))
    anc = fl.pack_anchors(anchors, dev)
    a = att.shape[1]

    sums, best = fl._launch_fwd(att, bbx, *anc, gt, w, *MATCH)
    want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w)
    if float(sums[2]) != float(want[2]) or not torch.allclose(sums[:2], want[:2], rtol=1e-4, atol=0.0):
        raise AssertionError(f"K1 {sums.tolist()} differs from its plain version {want.tolist()}")
    n = sums[2].clamp(min=1.0)
    grad = torch.stack([1.0 / n, 1.0 / n, torch.zeros_like(n)])  # d mean loss / d sums, lamb_reg 1
    want_grads = fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad)
    errors = {}
    for name in fl.BWD_VARIANTS:
        got = fl.launch_bwd_variant(name, att, bbx, *anc, gt, w, best, grad)
        errors[name] = max(float((g - x).abs().max()) for g, x in zip(got, want_grads))
        if not errors[name] <= 1e-6:
            raise AssertionError(f"K2's {name} kernel differs from its plain version by {errors[name]} (atol 1e-6)")

    def k2(name):
        return lambda: fl.launch_bwd_variant(name, att, bbx, *anc, gt, w, best, grad)

    names = list(fl.BWD_VARIANTS)
    back_to_back = {}
    for name in names + names[::-1]:  # in turns, so that no kernel alone meets a warmer or a throttled card
        t = _ms(k2(name), iters)
        back_to_back[name] = min(back_to_back.get(name, t), t)
    on_card = {name: _device_ms(k2(name), 20) for name in names}
    fwd = lambda: fl.fused_match_loss(att, bbx, *anc, gt, w)  # noqa: E731
    bwd = lambda: fl.fused_match_loss_backward(att, bbx, *anc, gt, w, best, grad)  # noqa: E731
    positives = int(fl._labels(anc[0], gt, MATCH[0], MATCH[1])[0].sum())
    return {
        "shape": [b, a],
        "positives": positives,
        "k1_ms": _ms(fwd, iters),
        "k1_device_ms": _device_ms(fwd, 20),
        "k1_plain_ms": _ms(lambda: fl.fused_match_loss_reference(att, bbx, *anc, gt, w), iters),
        "k1_max_abs_err": float((sums.double() - want.double()).abs().max()),
        "k2_kernel": fl.BWD_KERNEL,
        "k2_ms": _ms(bwd, iters),
        "k2_device_ms": on_card[fl.BWD_KERNEL],
        **{f"k2_{name}_ms": t for name, t in back_to_back.items()},
        **{f"k2_{name}_device_ms": t for name, t in on_card.items()},
        **{f"k2_{name}_max_abs_err": e for name, e in errors.items()},
        "k2_plain_ms": _ms(lambda: fl.fused_match_loss_backward_reference(att, bbx, *anc, gt, w, grad), iters),
        # K1: att, bbx, both anchor arrays, gt and w read; 3 sums and B argmax anchors written.
        "k1_bytes": b * a * (4 + 16) + a * 32 + b * (16 + 4) + 3 * 4 + b * 4,
        # K2: att, tlbr, gt, w, best and grad read; datt and dbbx written; bbx and cthw at positives.
        "k2_bytes": b * a * (4 + 4 + 16) + a * 16 + positives * 32 + b * (16 + 4 + 4) + 3 * 4,
        "k2_bytes_every_anchor": 2 * b * a * (4 + 16) + a * 32 + b * (16 + 4 + 4) + 3 * 4,
        "device": torch.cuda.get_device_name(dev),
    }


def main(argv: list[str]) -> int:
    b = int(argv[0]) if argv else 16
    mdl = argv[1] if len(argv) > 1 else "retina"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps(bench(b, mdl_to_use=mdl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
