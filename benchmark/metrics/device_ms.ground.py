"""Device milliseconds per device batch of the serving batcher over the profiled stretch."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.device_ms(rec, "batches")
