"""K1 against its roofline in rank 0's profiled data-parallel steps, in %."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.kernel_roofline(rec, "match_loss_row", "k1")
