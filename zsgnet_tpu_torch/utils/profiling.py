"""Profiling and tracing — port of ``zsgnet_tpu/utils/profiling.py``.

* :func:`profile_trace` — ``torch.profiler`` around a region, CPU and (on a
  machine with a card) CUDA activities, written as a Chrome trace;
* :func:`time_fn` — steady-state seconds per call, closed by
  ``torch.cuda.synchronize`` when the card is in use;
* :func:`device_kernels` — each CUDA kernel's time on the card and its
  launches per call of a function, from ``torch.profiler``;
* :class:`Timer` — accumulating host-side section timer (the loader's host
  ms per batch);
* :func:`flops_estimate` — the JAX package's analytic forward FLOPs per
  query, for achieved-rate arithmetic.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

from zsgnet_tpu_torch.ops.anchors import feature_map_sizes


@contextlib.contextmanager
def profile_trace(logdir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region and write ``<logdir>/trace_<ns>.json``, a
    Chrome trace (chrome://tracing or Perfetto). Yields the profiler, whose
    ``key_averages()`` sums the same events; ``trace_path`` names the file
    once the region has closed."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.trace_path = logdir / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable[..., Any], *args: Any, warmup: int = 3, iters: int = 100) -> tuple[float, Any]:
    """Steady-state seconds per call of ``fn(*args)`` after ``warmup``
    calls, and the last output."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters, out


def device_kernels(fn: Callable[[], Any], iters: int) -> list[tuple[str, float, float]]:
    """(kernel name, device ms per call, launches per call) of ``fn()`` over
    ``iters`` calls after one warm call, from torch.profiler's CUDA
    activity, largest first. Needs a card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows: list = []
    for _ in range(3):  # the profiler now and then returns a window without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # User annotations on the device timeline (Optimizer.step#Adam.step)
        # span kernels that are counted on their own; they carry the name of
        # their host-side range, which no kernel has.
        events = prof.key_averages()
        host_names = {e.key for e in events if e.device_type == DeviceType.CPU}
        rows = [
            (e.key, getattr(e, "self_device_time_total", 0.0) / 1e3 / iters, e.count / iters)
            for e in events
            if e.device_type == DeviceType.CUDA and e.key not in host_names
        ]
        if rows:
            break
    return sorted(rows, key=lambda r: -r[1])


class Timer:
    """Accumulating section timer for host-side pipeline profiling."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": 1000 * v / self.counts[k]}
            for k, v in self.totals.items()
        }


def flops_estimate(cfg) -> float:
    """Rough forward FLOPs per query of the retina model: ResNet-50 at
    4.1 GFLOPs at 224², scaled by area, plus the fusion head's convs."""
    h, w = cfg.resize_img
    resnet = 4.1e9 * (h * w) / (224 * 224)
    head = 0.0
    in_ch = cfg.fpn_ch + 2 * cfg.lstm_dim + 2
    for fh, fw in feature_map_sizes((h, w)):
        cells = fh * fw
        head += 2 * cells * 9 * (
            in_ch * cfg.head_ch
            + 3 * cfg.head_ch * cfg.head_ch
            + cfg.head_ch * cfg.num_anchors * 5
        )
    return resnet + head
