"""Device milliseconds per data-parallel training step on rank 0's card."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.device_ms(rec, "steps")
