"""The 95th-percentile latency of every request answered in the window, from
before the client's submit to the return of its wait, in ms (a failed
request counts as never answered)."""


def read(rec: dict) -> float | None:
    return rec["window"].get("p95_ms")
