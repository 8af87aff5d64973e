"""Model FLOP/s of the data-parallel training window over the four cards' bf16 peak, in %."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.mfu(rec, 3)
