"""Host milliseconds per data-parallel step inside dp::all_reduce on rank 0."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.allreduce_ms(rec)
