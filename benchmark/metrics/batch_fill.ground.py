"""Mean pairs per device batch over the window: the differences of the
serving batcher's own counters (``MicroBatcher.stats()``: batches, and the
mean fill times batches) between the window's two ends."""


def read(rec: dict) -> float | None:
    w = rec["window"]
    return w["fill"] / w["batches"] if w.get("batches") else None
