"""Device milliseconds per training step over the profiled steps."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.device_ms(rec, "steps")
