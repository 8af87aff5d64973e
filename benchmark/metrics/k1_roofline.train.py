"""K1 (the fused match and loss forward) against its roofline in the profiled steps, in %."""

from benchmark import metrics_common as common


def read(rec: dict) -> float | None:
    return common.kernel_roofline(rec, "match_loss_row", "k1")
