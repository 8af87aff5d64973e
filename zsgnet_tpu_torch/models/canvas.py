"""Canvas packing — run the shared fusion head once over all pyramid levels.

A copy of ``zsgnet_tpu/models/canvas.py``'s layout (numpy only). The five
level maps go into one zero-separated spatial canvas, and each head conv
runs once over it instead of once per level: 5× fewer conv launches per
layer, at the cost of ~1.2× padding work (38×62 = 2356 cells against 1939
summed for the 300² retina pyramid (38, 19, 10, 5, 3); SSD's
(38, 19, 10, 5, 3, 1) packs to the same canvas).

Exactness (``tests/test_torch_canvas.py``):

  * levels are separated by a ``gap`` of ≥ 1 zero cells, so a 3×3 tap at a
    level's border reads exactly the zeros per-level zero padding supplies;
  * after every conv + bias + ReLU the canvas is multiplied by the
    occupancy mask, re-zeroing the gap cells before the next conv reads
    them;
  * each level's output is a static slice of the canvas output.

The port's head concatenates [visual | query broadcast | grid] before its
first conv, and on the canvas the query and grid channels are zero in the
gaps like the visual ones: the padding a per-level conv sees in every
channel. So the port needs no border masks; the JAX head needs them only
because it splits conv0 into visual, query and grid terms and evaluates the
query term as spatially constant.

Packing is a shelf heuristic: the largest level anchors the left edge,
the rest stack in column shelves to its right.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from zsgnet_tpu_torch.ops import anchors as anchor_ops


@dataclasses.dataclass(frozen=True)
class CanvasLayout:
    """Static canvas geometry: per-level top-left offsets in cell coords."""

    height: int
    width: int
    offsets: tuple[tuple[int, int], ...]  # (row, col) per level
    sizes: tuple[tuple[int, int], ...]  # (h, w) per level


def pack_levels(sizes: Sequence[tuple[int, int]], gap: int = 1) -> CanvasLayout:
    """Shelf-pack pyramid levels into a canvas with ``gap`` zero cells
    between any two levels (gap ≥ 1 suffices for 3×3 convs)."""
    sizes = [(int(h), int(w)) for h, w in sizes]
    if sizes != sorted(sizes, reverse=True):
        raise ValueError(f"pack_levels expects levels sorted large→small, got {sizes}")
    h0, w0 = sizes[0]
    offsets: list[tuple[int, int]] = [(0, 0)]
    cx = w0 + gap  # current shelf column
    cy = 0  # next free row within the shelf
    shelf_w = 0  # widest level placed in the current shelf
    for h, w in sizes[1:]:
        if cy + h > h0:  # start a new shelf
            cx += shelf_w + gap
            cy, shelf_w = 0, 0
        offsets.append((cy, cx))
        cy += h + gap
        shelf_w = max(shelf_w, w)
    return CanvasLayout(h0, cx + shelf_w, tuple(offsets), tuple(sizes))


def canvas_constants(layout: CanvasLayout) -> dict[str, np.ndarray]:
    """The canvas's constants, float32, HWC as in the JAX package:
    ``grid`` (H, W, 2), each level's normalized (y, x) center grid
    (``ops.anchors.create_grid``) at its offset, zeros in the gaps; and
    ``occupancy`` (H, W, 1), 1 on level cells, 0 elsewhere."""
    grid = np.zeros((layout.height, layout.width, 2), np.float32)
    occ = np.zeros((layout.height, layout.width, 1), np.float32)
    for (r, c), (h, w) in zip(layout.offsets, layout.sizes):
        grid[r : r + h, c : c + w] = anchor_ops.create_grid((h, w), flatten=False)
        occ[r : r + h, c : c + w] = 1.0
    return {"grid": grid, "occupancy": occ}
