"""Arithmetic that several per-layer metric readers share: a record is
what ``run.py`` hands a reader (the cell's configuration and traffic, the
window's counts, and with ``--trace 1`` the profiled stretch)."""

from __future__ import annotations

import torch

from benchmark import counts
from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model


def device_ms(rec: dict, per: str) -> float | None:
    """Every device operation's duration (summed, not their union) over the
    profiled stretch, in ms a ``per`` ("steps" or "batches")."""
    n = rec["stretch"][per]
    if not n or not rec["trace"].device:
        return None
    return rec["trace"].device_seconds() * 1e3 / n


def idle_share(rec: dict) -> float | None:
    """The stretch's share with no device operation running, in %."""
    tr = rec["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.device else None


def mfu(rec: dict, passes: int) -> float | None:
    """The window's model FLOP/s over the bf16 dense peak of the cards it
    uses, in %: forward FLOPs per pair from the configuration's shapes (the
    query at the traffic's mean length) times ``passes`` (3 for forward and
    backward, no recomputation counted) times the pairs, over the wall time."""
    if rec["peaks"] is None:
        return None
    qlen = sum(rec["traffic"]["qlen"]) / 2
    flops = passes * counts.forward_flops(rec["cfg"], qlen) * rec["window"]["pairs"]
    return 100.0 * flops / rec["window"]["s"] / (rec["peaks"]["bf16"] * rec.get("chips", 1))


def positives(cfg: dict, annot) -> int:
    """Positive anchors of a batch's boxes, by the reference's matching."""
    anchors = ref_model.anchors(cfg, torch.float32)
    pos, _ = ref_loss.labels(cfg, anchors, torch.as_tensor(annot, dtype=torch.float32))
    return int(pos.sum())


def kernel_roofline(rec: dict, fragment: str, which: str) -> float | None:
    """The loss kernel named by ``fragment`` (K1 ``match_loss_row``, K2
    ``match_loss_grads``): the least seconds of its work in the profiled
    steps (``counts.k1_cost``/``k2_cost``, positives counted from each
    step's boxes) over its kernel seconds there, in %."""
    launches = rec["trace"].kernels(fragment)
    if not launches or rec["peaks"] is None:
        return None
    cost = counts.k1_cost if which == "k1" else counts.k2_cost
    b = rec["traffic"]["batch"]
    a = ref_model.anchors(rec["cfg"]).shape[0]
    least = sum(counts.least_seconds(*cost(b, a, positives(rec["cfg"], gt)), rec["peaks"])
                for gt in rec["stretch"]["annot"])
    measured = sum(dur for _, _, dur in launches) / 1e6
    return 100.0 * least / measured


def allreduce_ms(rec: dict) -> float | None:
    """Host ms a step inside ``dp::all_reduce`` ranges (``parallel/mesh.py``:
    the gradient buckets, the loss sums, the BatchNorm moments) on rank 0."""
    spans = [dur for name, _, dur in rec["trace"].host if name == "dp::all_reduce"]
    steps = rec["stretch"]["steps"]
    return sum(spans) / 1e3 / steps if spans and steps else None
