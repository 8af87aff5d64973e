"""Seeded inputs of the fused loss (kernels K1 and K2) that exercise its
edges: rows whose positives hang on the argmax anchor, and single
non-finite logits or deltas at each kind of anchor. Shared by the CPU tests
against the JAX package, the CUDA tests and ``chip_smoke.py``."""

from __future__ import annotations

import numpy as np


def k1_promotion_case(b: int, a: int = 5003, seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded inputs of the fused loss whose rows decide on the argmax anchor.

    ``a`` small anchors (sides up to 0.06) lie on a grid; a few larger ones
    (side 0.2) are planted at chosen indices, and each row's gt box is a
    shifted copy of one of them, so that anchor alone has a large IoU with
    it (a small anchor inside it has at most 0.09). At most 36 rows. Row
    kinds, by ``row % 4``:

    0. the best anchor has IoU ≈ 0.33, under ``match_thr`` 0.5, and lies in
       the ``1 + (row // 4) % 7``-th eighth of the anchors (never the
       first): it is positive only because it is the argmax;
    1. two identical anchors in different eighths tie for the maximum, also
       under ``match_thr``: the lower index is the argmax;
    2. a gt box of zero extent: every IoU is 0 and anchor 0 is the argmax;
    3. the best anchor has IoU ≈ 0.72, over ``match_thr``.

    Every fifth row (``row % 5 == 4``) has weight 0. Returns anchors_cthw
    (a, 4), att (b, a), bbx (b, a, 4), gt (b, 4) tlbr, w (b,) and best (b,),
    the argmax anchors the rows were built to have.
    """
    if b > 36:
        raise ValueError("k1_promotion_case places at most 36 rows")
    rng = np.random.default_rng(seed)
    eighth = -(-a // 8)
    side = int(np.ceil(np.sqrt(a)))
    cy, cx = np.divmod(np.arange(a), side)
    centers = np.stack([cy, cx], axis=1) / (side - 1) * 1.8 - 0.9
    anchors = np.concatenate([centers, rng.uniform(0.02, 0.06, size=(a, 2))], axis=1)
    gt = np.zeros((b, 4))
    best = np.zeros((b,), np.int64)
    for row in range(b):
        kind = row % 4
        # A planted anchor of side 0.2 of this row's own, clear of the others' gt boxes.
        center = np.array([-0.75 + 0.3 * (row % 6), -0.75 + 0.3 * (row // 6)])
        first = (1 + (row // 4) % 7) * eighth + 11 + row
        if kind == 2:
            gt[row] = (0.3, 0.3, 0.3, 0.3)
            best[row] = 0
            continue
        anchors[first] = (*center, 0.2, 0.2)
        best[row] = first
        if kind == 1:
            second = min(first + 2 * eighth, a - 1 - row) if first + 2 * eighth < a else first - eighth
            anchors[second] = anchors[first]
            best[row] = min(first, second)
        # gt = the planted box shifted along y by d: IoU = (0.2 - d) / (0.2 + d).
        d = 0.1 if kind in (0, 1) else 0.032
        gt[row] = (center[0] - 0.1 + d, center[1] - 0.1, center[0] + 0.1 + d, center[1] + 0.1)
    w = np.ones((b,))
    w[4::5] = 0.0
    f32 = np.float32
    return {
        "anchors_cthw": anchors.astype(f32),
        "att": (rng.normal(size=(b, a)) * 2).astype(f32),
        "bbx": rng.normal(size=(b, a, 4)).astype(f32),
        "gt": gt.astype(f32),
        "w": w.astype(f32),
        "best": best,
    }


NONFINITE_LABELS = ("positive", "promoted", "ignored", "negative")


def nonfinite_case(value: float, where: str, label: str, weight: float, seed: int = 0) -> dict:
    """Seeded inputs of the fused loss with one non-finite logit or delta.

    600 small anchors (sides up to 0.06) on a grid and three planted ones of
    side 0.2, over 8 rows (the JAX kernel takes B % 8 == 0). Row 0's gt box
    has IoU 0.72 with one planted anchor and 0.45 with another; row 1's has
    0.33 with the third, its argmax. ``label`` picks the anchor that gets
    ``value`` (NaN, +inf or -inf) in ``where`` ("att", or "bbx" at its
    second coordinate): ``positive`` (IoU ≥ match_thr), ``promoted`` (row
    1's argmax under match_thr), ``ignored`` (IoU in [neg_thr, match_thr))
    or ``negative`` (IoU 0). That row has weight ``weight``, the others 1.
    Returns anchors_cthw, att, bbx, gt, w and (row, anchor).
    """
    rng = np.random.default_rng(seed)
    a, b = 600, 8
    side = int(np.ceil(np.sqrt(a)))
    cy, cx = np.divmod(np.arange(a), side)
    anchors = np.concatenate([np.stack([cy, cx], axis=1) / (side - 1) * 1.8 - 0.9,
                              rng.uniform(0.02, 0.06, size=(a, 2))], axis=1)
    c0, c1 = np.array([-0.4, -0.4]), np.array([0.4, 0.4])
    # A copy of a gt box shifted along y by d has IoU (0.2 - d) / (0.2 + d).
    anchors[101] = (c0[0] - 0.032, c0[1], 0.2, 0.2)   # 0.72 with row 0
    anchors[333] = (c0[0] + 0.0759, c0[1], 0.2, 0.2)  # 0.45 with row 0
    anchors[457] = (c1[0] - 0.1, c1[1], 0.2, 0.2)     # 0.33 with row 1
    lo = rng.uniform(-0.9, 0.3, size=(b - 2, 2))
    gt = np.concatenate([np.stack([np.r_[c0 - 0.1, c0 + 0.1], np.r_[c1 - 0.1, c1 + 0.1]]),
                         np.concatenate([lo, lo + 0.5], axis=1)])
    row, anchor = {"positive": (0, 101), "promoted": (1, 457), "ignored": (0, 333),
                   "negative": (0, 599)}[label]
    f32 = np.float32
    att = (rng.normal(size=(b, a)) * 2).astype(f32)
    bbx = rng.normal(size=(b, a, 4)).astype(f32)
    if where == "att":
        att[row, anchor] = value
    else:
        bbx[row, anchor, 1] = value
    w = np.ones((b,), f32)
    w[row] = weight
    return {"anchors_cthw": anchors.astype(f32), "att": att, "bbx": bbx, "gt": gt.astype(f32), "w": w,
            "at": (row, anchor)}
