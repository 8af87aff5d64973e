"""The yardstick's arithmetic: the card's published peaks, model FLOPs per
pair from the configuration's shapes, and the least bytes and operations of
the fused loss kernels (K1, the match and loss forward; K2, its backward).

Model FLOPs count every convolution and the LSTM's matrix products at two
per multiply-add, from the published layer shapes alone, so a share reads
the same work whatever implements it. BatchNorm, ReLU, pooling, the
upsampling, the embedding lookup, the loss and the decode are left out: they
are no matrix work and a small share of the operations.
"""

from __future__ import annotations

from benchmark.reference.model import (
    RESNET_STAGES, SSD_EXTRAS, level_channels, level_sizes, num_anchors, vgg_layers,
)

# Dense peaks of the SXM part at its 700 W limit (NVIDIA's H100 data sheet):
# bf16 tensor-core FLOP/s, float32 FLOP/s outside the tensor cores, HBM bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
}

# Operations per anchor of a row that the loss kernels need, counted from
# their formulas: IoU with the row's box (4 max/min, 2 sub-products, areas,
# union, divide: 15), the focal term (sigmoid, log1p(exp(-|x|)), the
# (1 - p_t)^2 weight and α_t: 20) and its gradient (30); at a positive anchor
# the box targets (2 divides, 2 logs, 6 more: 10) and the smooth-L1 of four
# deltas (16) or its gradient (12).
K1_PER_ANCHOR, K1_PER_POSITIVE = 35, 26
K2_PER_ANCHOR, K2_PER_POSITIVE = 45, 22


def _out(n: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def backbone_flops(cfg: dict) -> int:
    """One image through ResNet-50 + FPN or the SSD VGG-16 tower and extras."""
    h, w = cfg["resize_img"]
    total = 0
    if cfg["mdl_to_use"] == "retina":
        h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
        total += _conv(3, 64, 7, h, w)
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        cin, taps = 64, []
        for s, (n, width) in enumerate(RESNET_STAGES):
            for i in range(n):
                stride = 2 if (i == 0 and s > 0) else 1
                ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
                total += _conv(cin, width, 1, h, w) + _conv(width, width, 3, ho, wo) \
                    + _conv(width, 4 * width, 1, ho, wo)
                if i == 0:
                    total += _conv(cin, 4 * width, 1, ho, wo)
                cin, h, w = 4 * width, ho, wo
            if s >= 1:
                taps.append((cin, h, w))
        c = cfg["fpn_ch"]
        for cin, th, tw in taps:  # laterals and 3×3 smoothing at C3, C4, C5
            total += _conv(cin, c, 1, th, tw) + _conv(c, c, 3, th, tw)
        _, h5, w5 = taps[-1]
        h6, w6 = _out(h5, 3, 2, 1), _out(w5, 3, 2, 1)
        total += _conv(2048, c, 3, h6, w6) + _conv(c, c, 3, _out(h6, 3, 2, 1), _out(w6, 3, 2, 1))
        return total
    for _, kind, args in vgg_layers():
        if kind == "pool":
            k, s, p, ceil = args
            h, w = (-(-(h + 2 * p - k) // s) + 1, -(-(w + 2 * p - k) // s) + 1) if ceil \
                else (_out(h, k, s, p), _out(w, k, s, p))
        elif kind == "conv":
            cin, cout, k, p, d = args
            h, w = _out(h, k, 1, p, d), _out(w, k, 1, p, d)
            total += _conv(cin, cout, k, h, w)
    for cin, cout, k, s, p in SSD_EXTRAS:
        ph = (1 if h < 3 else 0) if p is None else p
        pw = (1 if w < 3 else 0) if p is None else p
        h, w = _out(h, k, s, ph), _out(w, k, s, pw)
        total += _conv(cin, cout, k, h, w)
    return total


def head_flops(cfg: dict) -> int:
    """One pair through the fusion head at every level."""
    q, c, a = 2 * cfg["lstm_dim"], cfg["head_ch"], num_anchors(cfg)
    total = 0
    for ch, (h, w) in zip(level_channels(cfg), level_sizes(cfg)):
        total += _conv(ch + q + 2, c, 3, h, w) + 3 * _conv(c, c, 3, h, w) + _conv(c, 5 * a, 3, h, w)
    return total


def lstm_flops(cfg: dict, qlen: float) -> float:
    """One query of ``qlen`` tokens through both directions."""
    e, h = cfg["emb_dim"], cfg["lstm_dim"]
    return 2 * qlen * (2 * e * 4 * h + 2 * h * 4 * h)


def forward_flops(cfg: dict, qlen: float, pairs_per_image: int = 1) -> float:
    """Model FLOPs of one pair's forward pass."""
    return backbone_flops(cfg) / pairs_per_image + head_flops(cfg) + lstm_flops(cfg, qlen)


def k1_cost(b: int, a: int, n_pos: int) -> tuple[float, float]:
    """(operations, bytes) that K1 needs for B rows over A anchors with
    ``n_pos`` positives in all: the logits and the anchors' tlbr read once,
    the deltas and anchor centres at the positives only, each row's box and
    weight, and the sums, argmaxes and per-row partial sums written."""
    ops = b * a * K1_PER_ANCHOR + n_pos * K1_PER_POSITIVE
    nbytes = 4 * b * a + 16 * a + 32 * n_pos + b * (16 + 4) + 12 + 4 * b + 12 * b
    return ops, nbytes


def k2_cost(b: int, a: int, n_pos: int) -> tuple[float, float]:
    """(operations, bytes) that K2 needs: K1's reads, the argmaxes and the
    upstream gradient, and both gradients written whole."""
    ops = b * a * K2_PER_ANCHOR + n_pos * K2_PER_POSITIVE
    nbytes = 4 * b * a + 16 * a + 32 * n_pos + b * (16 + 4 + 4) + 12 + 4 * b * a + 16 * b * a
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, peaks: dict, flops_key: str = "fp32") -> float:
    """The roofline's least time: the larger of the operations at the peak
    rate and the bytes at the memory's."""
    return max(ops / peaks[flops_key], nbytes / peaks["hbm"])
