"""Cells at a size a CPU test run holds: the benchmark's own configuration,
traffic and limit files with the widths, image and batch cut down, driven
through the same harness on the CPU (the program's plain kernel versions)."""

from __future__ import annotations

import importlib

import torch

from benchmark import harness

CPU = torch.device("cpu")
SMALL = {"resize_img": [64, 64], "fpn_ch": 16, "head_ch": 16, "emb_dim": 8, "lstm_dim": 8,
         "vocab_size": 60, "compute_dtype": "float32"}
# At this size one Adam step of 1e-4 is chaotic through ResNet-50's BatchNorm
# (a 1e-6 change of a weight moves the next loss by ~1e-2); 1e-6 is not.
SMALL_LR = 1e-6
TRAFFIC = {"train": {"batch": 4, "ring": 4}, "train_dp": {"batch": 2, "ring": 4, "ranks": 2},
           "ground": {"clients": 8, "batch_size": 4, "images": 16, "sample": 8, "warm_s": 0.3, "trace_s": 0.2}}


def small_cell(cell: str, **traffic) -> harness.Cell:
    """``cell`` of ``BENCHMARK.json`` at the small size, its limits as they are."""
    full = harness.load_cell(cell)
    kind = full.traffic["kind"]
    cfg = dict(full.config, **SMALL, lr=SMALL_LR)
    return harness.Cell(cell, full.chips, cfg, dict(full.traffic, **{**TRAFFIC[kind], **traffic}),
                        importlib.import_module(f"benchmark.kinds.{kind}"), full.limits,
                        full.end_to_end, full.per_layer)
