"""Model FLOP/s of the training window (forward and backward) over the card's bf16 peak, in %."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.mfu(rec, 3)
