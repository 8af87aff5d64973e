"""A profiled stretch and what the per-layer metrics read from it.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activity) inside one host range, writes the Chrome trace into a temporary
directory under ``TMPDIR``, reads it back and deletes it. A :class:`Trace`
holds the device operations (kernels, copies, fills), the host operations
and the stretch's bounds, all in microseconds on the trace's one clock.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 160  # breakdown names are cut here; cuDNN's run to hundreds


@dataclass
class Trace:
    start: float
    end: float
    device: list[tuple[str, float, float]] = field(default_factory=list)  # (name, ts, dur), µs
    host: list[tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self, fragment: str = "") -> list[tuple[str, float, float]]:
        """Device operations inside the stretch whose name holds ``fragment``."""
        return [e for e in self.device if fragment in e[0]]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the stretch."""
        spans = sorted((max(ts, self.start), min(ts + dur, self.end)) for _, ts, dur in self.device)
        merged: list[list[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The stretch's stretches with no device operation running."""
        out, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def device_seconds(self, fragment: str = "") -> float:
        """Summed durations (not their union) of the matching device operations."""
        return sum(dur for _, _, dur in self.kernels(fragment)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing: each instant of every gap goes to the
        innermost host operation open then (any thread), or to "(no host
        operation)" where none is (Python between calls)."""
        by_op: dict[str, float] = defaultdict(float)
        for name, _, dur in self.device:
            by_op[name[:NAME_CHARS]] += dur / 1e6
        host = sorted(self.host, key=lambda e: e[1])
        by_host: dict[str, float] = defaultdict(float)
        open_ops: list[tuple[str, float, float]] = []
        i = 0
        for a, b in self.gaps():  # in time order: a sweep over the host operations
            while i < len(host) and host[i][1] < b:
                open_ops.append(host[i])
                i += 1
            open_ops = [e for e in open_ops if e[1] + e[2] > a]
            for name, t in _innermost(open_ops, a, b):
                by_host[name[:NAME_CHARS]] += t / 1e6
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": pick(by_op), "idle_gaps": pick(by_host)}


def _innermost(ops: list[tuple[str, float, float]], a: float, b: float) -> list[tuple[str, float]]:
    """Split [a, b] by the shortest of ``ops`` open at each instant: a sweep
    with a heap of the open operations by duration → (name, µs) pieces."""
    edges = sorted([(max(ts, a), 0, i) for i, (_, ts, _) in enumerate(ops)]
                   + [(min(ts + dur, b), 1, i) for i, (_, ts, dur) in enumerate(ops)] + [(b, 2, -1)])
    heap: list[tuple[float, int]] = []
    closed: set[int] = set()
    out, t = [], a
    for when, what, i in edges:
        while heap and heap[0][1] in closed:
            heapq.heappop(heap)
        if when > t:
            out.append((ops[heap[0][1]][0] if heap else "(no host operation)", when - t))
            t = when
        if what == 0:
            heapq.heappush(heap, (ops[i][2], i))
        elif what == 1:
            closed.add(i)
    return out


def parse(events: list[dict]) -> Trace:
    """A Chrome trace's events → the :class:`Trace` of its ``STRETCH`` range
    (the whole trace where there is none)."""
    marks = [e for e in events if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if marks:
        start, end = float(marks[0]["ts"]), float(marks[0]["ts"]) + float(marks[0]["dur"])
    else:
        start = min(float(e["ts"]) for e in timed)
        end = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    tr = Trace(start, end)
    for e in timed:
        ts, dur = float(e["ts"]), float(e["dur"])
        if ts + dur <= start or ts >= end or e.get("name") == STRETCH:
            continue
        if e.get("cat") in DEVICE_CATS:
            tr.device.append((e["name"], ts, dur))
        elif e.get("cat") in HOST_CATS:
            tr.host.append((e["name"], ts, dur))
    return tr


def profiled(fn: Callable[[], object]) -> Trace:
    """Run ``fn`` under the profiler, between two device synchronizes, and
    return its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(STRETCH):
                sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
                sync()
                fn()
                sync()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events)
