"""Model FLOP/s of the grounding window (forward only, padding not counted) over the card's bf16 peak, in %."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.mfu(rec, 1)
