"""Share of rank 0's profiled data-parallel steps with no device operation running, in %."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.idle_share(rec)
