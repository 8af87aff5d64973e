"""Serving daemon — torch port of ``zsgnet_tpu/serve.py``: a checkpoint or
an exported artifact behind stdlib HTTP (``http.server``).

**Micro-batching.** Concurrent requests coalesce in a queue; one worker
thread drains up to ``batch_size`` of them (waiting at most ``window_ms``
for stragglers after the first) and runs one ``Grounder.ground`` call for
the group, padded to the smallest shape bucket that fits. The worker runs
every device call, so CUDA is used from that one thread; handler threads
only decode and enqueue.

Endpoints (JSON):
    GET  /healthz → {"ok": true, "batch_size": N, ...}
    GET  /statz   → serving counters: requests/batches/errors totals,
                    mean micro-batch fill, recent p50/p95/max latency,
                    queue depth, shed pairs, uptime
    POST /ground  {"query": str, "image_b64": <base64 PNG/JPEG>}
                  or {"query": str, "image_path": <server-local path>}
                  or {"requests": [<either form>, ...]}
                  or {"queries": [str, ...], "image_b64"|"image_path": ...}
      → {"box_xyxy": [x1,y1,x2,y2], "box_norm": [...], "score": s}
        (original-image pixel coordinates; lists under "results" for
        the batched and multi-query forms)

The ``queries`` form grounds N phrases against one image in one
shared-backbone pass (``Grounder.ground_image``) and ships one image's
bytes instead of N. Admission is bounded (``max_queue`` pairs, in-flight
included): beyond it a request gets 503 with ``Retry-After: 1``.

CLI:
    python -m zsgnet_tpu_torch.serve <ckpt_or_artifact_dir> [--port=8500]
        [--batch_size=8] [--window_ms=5] [--max_queue=N] [--host=127.0.0.1]
        [--warmup=false] [--oov_slots=N] [--glove=<file>] [--device=cuda]
        [--quantize=true] [--data_parallel=true] [--mesh_spatial=N] [--key=val ...]

A directory holding ``export.json`` is served through
``export.ExportedGrounder`` (its batch size and buckets are the
artifact's), any other as a checkpoint through ``Grounder.from_checkpoint``.
``--warmup`` (default true) runs every pair and multi-query bucket before
the daemon takes requests. SIGTERM stops accepting and answers the
requests already accepted before the process exits.

``--data_parallel=true`` serves on every local device of the requested
type: a checkpoint through a ``Grounder`` with one replica per device, each
device batch split over them; an artifact with whole device batches
round-robin over the devices.

``--mesh_spatial=N`` serves a checkpoint with each image's height split
over N members (``Grounder(mesh_spatial=N)``) on every local device of the
requested type, N to a group. With fewer than N devices the members share
them (two on one card: exact, but not faster). An artifact directory is
refused, as in the JAX package.
"""

from __future__ import annotations

import base64
import collections
import json
import queue
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import torch

from zsgnet_tpu_torch.data.dataset import load_image_bytes_u8
from zsgnet_tpu_torch.export import ExportedGrounder
from zsgnet_tpu_torch.parallel.mesh import local_devices
from zsgnet_tpu_torch.predict import Grounder, is_true
from zsgnet_tpu_torch.utils.backend import resolve_device


@dataclass
class _Pending:
    image: object          # path str or pre-resized HWC uint8 array
    query: str
    orig_hw: tuple | None  # set for decoded-bytes images → rescale output
    event: threading.Event = field(default_factory=threading.Event)
    result: dict | None = None
    error: str | None = None
    t_submit: float = 0.0  # monotonic enqueue time → /statz latency


@dataclass
class _PendingMulti:
    """One image × N queries, served by ``Grounder.ground_image`` as a
    device batch of its own: the worker never mixes it into a pair batch."""

    image: object
    queries: list
    orig_hw: tuple | None
    event: threading.Event = field(default_factory=threading.Event)
    result: list | None = None  # one dict per query
    error: str | None = None
    t_submit: float = 0.0


class ServerOverloadedError(RuntimeError):
    """The admission queue is full: shed the request (503 + Retry-After)
    instead of parking the client. Capacity counts pairs admitted and not
    yet answered."""


class MicroBatcher:
    """Coalesce concurrent ``ground`` calls into device batches.

    ``max_queue`` bounds admission in pairs, in-flight included (default 32
    device batches); beyond it a submission raises
    :class:`ServerOverloadedError`. A request with more pairs than
    ``max_queue`` is still admitted onto an empty queue, so it is never
    refused forever; at most one such request rides above the cap."""

    # A request waits this long for its batch at most.
    DEFAULT_TIMEOUT = 900.0

    def __init__(self, grounder, window_ms: float = 5.0, max_queue: int | None = None):
        self._g = grounder
        self._window = window_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self.max_queue = int(max_queue) if max_queue else 32 * int(grounder.bs)
        # Counters for /statz, changed only under _stats_lock; the
        # latencies are a bounded ring, so percentiles follow recent load.
        self._stats_lock = threading.Lock()
        self._t_start = time.monotonic()
        self._depth = 0       # pairs admitted, not yet answered
        self._n_shed = 0      # pairs refused with 503
        self._n_requests = 0
        self._n_batches = 0
        self._n_errors = 0
        self._fill_sum = 0
        self._latencies: collections.deque = collections.deque(maxlen=512)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _admit(self, n: int) -> None:
        with self._stats_lock:
            if self._depth + n > self.max_queue and self._depth > 0:
                self._n_shed += n
                raise ServerOverloadedError(
                    f"queue full ({self._depth}/{self.max_queue} pairs in flight); retry later"
                )
            self._depth += n
            self._n_requests += n

    def submit_async(self, image, query: str, orig_hw=None) -> _Pending:
        """Enqueue without blocking, so a request list lands in one device
        batch instead of one micro-batch per item."""
        item = _Pending(image=image, query=query, orig_hw=orig_hw, t_submit=time.monotonic())
        self._admit(1)
        self._q.put(item)
        return item

    def submit_multi_async(self, image, queries: list, orig_hw=None) -> _PendingMulti:
        """Enqueue one image × N queries for ``Grounder.ground_image``;
        counts as N requests."""
        item = _PendingMulti(image=image, queries=list(queries), orig_hw=orig_hw,
                             t_submit=time.monotonic())
        self._admit(len(item.queries))
        self._q.put(item)
        return item

    def stats(self) -> dict:
        """The /statz counters."""
        with self._stats_lock:
            lat = sorted(self._latencies)
            n_req, n_bat = self._n_requests, self._n_batches
            n_err, fill = self._n_errors, self._fill_sum
            depth, shed = self._depth, self._n_shed
        pct = (
            {
                "p50_ms": round(lat[len(lat) // 2] * 1e3, 2),
                "p95_ms": round(lat[int(len(lat) * 0.95)] * 1e3, 2),
                "max_ms": round(lat[-1] * 1e3, 2),
            }
            if lat
            else {}
        )
        return {
            "requests": n_req,
            "batches": n_bat,
            "errors": n_err,
            "mean_batch_fill": round(fill / n_bat, 3) if n_bat else None,
            "batch_size": self._g.bs,
            "queue_depth": depth,
            "max_queue": self.max_queue,
            "shed": shed,
            "latency": pct,
            "uptime_s": round(time.monotonic() - self._t_start, 1),
        }

    def wait(self, item, timeout: float = DEFAULT_TIMEOUT):
        if not item.event.wait(timeout):
            raise TimeoutError("grounding timed out")
        if item.error is not None:
            raise RuntimeError(item.error)
        return item.result

    def submit(self, image, query: str, orig_hw=None, timeout: float = DEFAULT_TIMEOUT) -> dict:
        return self.wait(self.submit_async(image, query, orig_hw), timeout)

    def _done(self, items: list, n_pairs: int, n_failed: int) -> None:
        now = time.monotonic()
        with self._stats_lock:
            self._n_batches += 1
            self._fill_sum += n_pairs
            self._n_errors += n_failed
            for it in items:
                n = len(it.queries) if isinstance(it, _PendingMulti) else 1
                self._latencies.extend([now - it.t_submit] * n)
            self._depth -= n_pairs
        for it in items:
            it.event.set()

    def _worker(self) -> None:
        bs = self._g.bs
        carry = None  # a _PendingMulti that ended a pair batch's drain
        while True:
            first = carry if carry is not None else self._q.get()
            carry = None
            if isinstance(first, _PendingMulti):
                self._run_multi(first)
                continue
            items = [first]
            deadline = time.monotonic() + self._window
            while len(items) < bs:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if isinstance(nxt, _PendingMulti):
                    carry = nxt  # another shape: close this batch, run it next
                    break
                items.append(nxt)
            try:
                results = self._g.ground([it.image for it in items], [it.query for it in items])
                for it, res in zip(items, results):
                    it.result = _rescale_result(res, it.orig_hw) if it.orig_hw is not None else res
            except Exception as e:  # every waiting client gets the error
                for it in items:
                    it.error = f"{type(e).__name__}: {e}"
            finally:
                self._done(items, len(items), sum(1 for it in items if it.error))

    def _run_multi(self, item: _PendingMulti) -> None:
        try:
            results = self._g.ground_image(item.image, item.queries)
            if item.orig_hw is not None:
                results = [_rescale_result(res, item.orig_hw) for res in results]
            item.result = results
        except Exception as e:
            item.error = f"{type(e).__name__}: {e}"
        finally:
            n = len(item.queries)
            self._done([item], n, n if item.error else 0)


def _rescale_result(res: dict, orig_hw) -> dict:
    """box_norm (resized frame, normalized tlbr) → box_xyxy in the original
    pixel frame, for images the handler decoded from bytes."""
    oh, ow = orig_hw
    y1, x1, y2, x2 = res["box_norm"]
    return {
        **res,
        "box_xyxy": [(x1 + 1) * ow / 2, (y1 + 1) * oh / 2, (x2 + 1) * ow / 2, (y2 + 1) * oh / 2],
    }


def load_server_model(
    model_dir: str | Path, batch_size: int = 8, cfg_overrides: dict | None = None,
    data_parallel: bool = False, oov_slots: int = 0, glove_path: str | None = None,
    device: str | torch.device = "cuda", quantize: bool = False,
):
    """An artifact directory (``export.json`` in it) → ``ExportedGrounder``,
    a checkpoint directory → ``Grounder.from_checkpoint``. Both have
    ``ground``, ``ground_image``, ``warmup``, ``cfg``, ``vocab``, ``bs`` and
    ``bucket_sizes``. An artifact fixes its batch size, buckets, format and
    OOV capacity at export: ``cfg_overrides``, ``quantize`` and an
    ``oov_slots`` beyond its own are refused. ``data_parallel`` serves on
    every local device of ``device``'s type (``Grounder(devices=...)`` or
    ``ExportedGrounder.load(data_parallel=True)``). ``mesh_spatial`` in
    ``cfg_overrides`` (checkpoints only) serves spatially on every local
    device, as the JAX daemon's ``(data, spatial)`` mesh does; members share
    devices where there are fewer than ``mesh_spatial``."""
    device = resolve_device(device)
    sp = int((cfg_overrides or {}).get("mesh_spatial", 1) or 1)
    if (Path(model_dir) / "export.json").exists():
        if sp > 1:
            raise ValueError(
                "mesh_spatial serving needs a checkpoint dir — exported "
                "torch.export artifacts are lowered per device and cannot "
                "shard one sample; use --data_parallel for batch-level "
                "multi-device artifact serving"
            )
        if cfg_overrides or quantize:
            raise ValueError(f"an exported artifact serves as exported; cannot apply "
                             f"{dict(cfg_overrides or {}, **({'quantize': True} if quantize else {}))}")
        g = ExportedGrounder.load(model_dir, glove_path=glove_path, device=device,
                                  data_parallel=data_parallel)
        if oov_slots and not g.oov_slots:
            raise ValueError("this artifact has no OOV capacity — re-export with "
                             "--weights_as_args=true --oov_slots=N (v3)")
        return g
    devices = local_devices(device) if data_parallel or sp > 1 else None
    if sp > 1:
        if len(devices) >= sp and len(devices) % sp:
            raise ValueError(f"mesh_spatial={sp} does not divide the {len(devices)} devices; "
                             "pick a divisor or set mesh_shape=(n,) explicitly")
        if len(devices) < sp:
            print(f"serve: mesh_spatial={sp} on {len(devices)} device(s) — the members share them", flush=True)
            devices = [devices[i % len(devices)] for i in range(sp)]
    return Grounder.from_checkpoint(
        model_dir, batch_size=batch_size, cfg_overrides=cfg_overrides,
        oov_slots=oov_slots, glove_path=glove_path, device=device, quantize=quantize,
        devices=devices, mesh_spatial=sp,
    )


def make_server(grounder, port: int = 8500, window_ms: float = 5.0, host: str = "127.0.0.1",
                max_body_mb: float = 64.0, max_queue: int | None = None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server: ``.serve_forever()`` runs it,
    ``.shutdown()`` stops it. ``max_body_mb`` caps request bodies (413);
    ``max_queue`` bounds admitted pairs (503 + Retry-After beyond it)."""
    batcher = MicroBatcher(grounder, window_ms=window_ms, max_queue=max_queue)
    resize_hw = tuple(grounder.cfg.resize_img)
    max_body = int(max_body_mb * 1e6)

    def decode_image(req: dict):
        """→ (image, orig_hw): a decoded array for b64 bytes; a path string
        otherwise (orig_hw None: the Grounder reads the size at load)."""
        if "image_b64" in req:
            return load_image_bytes_u8(base64.b64decode(req["image_b64"]), resize_hw)
        if "image_path" in req:
            p = Path(req["image_path"])
            if not p.is_file():
                raise ValueError(f"no such image: {p}")
            return str(p), None
        raise ValueError("need 'image_b64' or 'image_path'")

    def enqueue_one(req: dict) -> _Pending:
        query = req.get("query")
        if not isinstance(query, str) or not query.strip():
            raise ValueError("missing 'query'")
        image, orig_hw = decode_image(req)
        return batcher.submit_async(image, query, orig_hw=orig_hw)

    def enqueue_multi(req: dict) -> _PendingMulti:
        queries = req.get("queries")
        if (not isinstance(queries, list) or not queries
                or not all(isinstance(q, str) and q.strip() for q in queries)):
            raise ValueError("'queries' must be a non-empty list of strings")
        image, orig_hw = decode_image(req)
        return batcher.submit_multi_async(image, queries, orig_hw=orig_hw)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict, headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._send(200, {"ok": True, "batch_size": grounder.bs,
                                 "resize_img": list(resize_hw), "window_ms": window_ms})
            elif self.path == "/statz":
                self._send(200, batcher.stats())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/ground":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > max_body:
                    self._send(413, {"error": f"body {n} bytes exceeds limit {max_body}"})
                    return
                req = json.loads(self.rfile.read(n) or b"{}")
                if "requests" in req:
                    # Enqueue all before waiting on any: the list coalesces
                    # into as few device batches as it can.
                    if any("queries" in r for r in req["requests"]):
                        raise ValueError("'queries' form must be a top-level request, "
                                         "not an element of 'requests'")
                    items = [enqueue_one(r) for r in req["requests"]]
                    self._send(200, {"results": [batcher.wait(it) for it in items]})
                elif "queries" in req:
                    self._send(200, {"results": batcher.wait(enqueue_multi(req))})
                else:
                    self._send(200, batcher.wait(enqueue_one(req)))
            except ServerOverloadedError as e:
                self._send(503, {"error": str(e)}, {"Retry-After": "1"})
            except (ValueError, KeyError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):  # quiet; the daemon prints its own lines
            pass

    class Server(ThreadingHTTPServer):
        # The default listen backlog (5) resets connections when a few dozen
        # clients connect at once, the burst micro-batching exists for.
        request_queue_size = 1024
        # Handler threads are not daemonic: after shutdown(), server_close()
        # joins them, so every accepted request is answered; the batcher's
        # timeout bounds how long that takes.
        daemon_threads = False

    return Server((host, port), Handler)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    overrides = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if len(args) != 1:
        raise SystemExit(__doc__)
    port = int(overrides.pop("port", "8500"))
    bs = int(overrides.pop("batch_size", "8"))
    window_ms = float(overrides.pop("window_ms", "5"))
    max_queue = int(overrides.pop("max_queue", "0")) or None
    host = overrides.pop("host", "127.0.0.1")
    quantize = is_true(overrides.pop("quantize", "false"))
    dp = is_true(overrides.pop("data_parallel", "false"))
    warm = is_true(overrides.pop("warmup", "true"))
    oov_slots = int(overrides.pop("oov_slots", "0"))
    glove_path = overrides.pop("glove", None)
    device = overrides.pop("device", "cuda")
    g = load_server_model(args[0], batch_size=bs, cfg_overrides=overrides or None,
                          data_parallel=dp, oov_slots=oov_slots, glove_path=glove_path,
                          device=device, quantize=quantize)
    if warm:
        t0 = time.time()
        print(f"warming buckets {g.bucket_sizes} …", flush=True)
        g.warmup(multiquery=True)
        print(f"warmed in {time.time() - t0:.1f}s", flush=True)
    srv = make_server(g, port=port, window_ms=window_ms, host=host, max_queue=max_queue)
    # shutdown() waits for serve_forever to stop, so it must run on another
    # thread than the one serve_forever runs on.
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(target=srv.shutdown, daemon=True).start())
    print(f"serving {args[0]} on http://{host}:{srv.server_address[1]} "
          f"(batch_size={g.bs}, window={window_ms}ms)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    srv.server_close()  # joins the handler threads still answering
    print("daemon stopped", flush=True)


if __name__ == "__main__":
    main()
