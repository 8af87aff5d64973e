"""Each traffic generator repeats byte for byte under one seed, differs
under another, and gives every seed the same lengths in another order."""

from __future__ import annotations

import numpy as np

from benchmark.kinds import ground, train
from benchmark.tests.small import small_cell

BIG_SEED = 2**31 + 12345


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_train_ring_repeats_and_differs():
    c = small_cell("retina300.train.b128")
    r1, r2 = (train.make_ring(c.config, c.traffic, BIG_SEED) for _ in range(2))
    other = train.make_ring(c.config, c.traffic, BIG_SEED + 1)
    assert all(_same(a, b) for a, b in zip(r1, r2))
    assert not any(np.array_equal(a["img"], b["img"]) for a, b in zip(r1, other))
    lens = lambda ring: np.sort(np.concatenate([b["qlens"] for b in ring]))  # noqa: E731
    assert np.array_equal(lens(r1), lens(other))
    lo, hi = c.traffic["qlen"]
    for b in r1:
        assert b["img"].dtype == np.uint8 and b["qlens"].min() >= lo and b["qlens"].max() <= hi
        assert ((b["qvec"] > 0).sum(1) == b["qlens"]).all()
        box = b["annot"]
        assert (box[:, 2:] > box[:, :2]).all() and box.min() >= -1 and box.max() <= 1


def test_ground_requests_repeat_and_differ():
    c = small_cell("retina300.ground.c256")
    a, b = (ground.make_requests(c.config, c.traffic, BIG_SEED) for _ in range(2))
    other = ground.make_requests(c.config, c.traffic, BIG_SEED + 1)
    assert _same(a, b)
    assert not np.array_equal(a["img"], other["img"]) and not np.array_equal(a["words"], other["words"])
    assert np.array_equal(np.sort(a["qlen"]), np.sort(other["qlen"]))
    assert a["image"].max() < c.traffic["images"] and a["words"].min() >= 2
