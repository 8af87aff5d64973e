"""The port's serving daemon (``zsgnet_tpu_torch.serve``) on the CPU: the
cases of tests/test_serve.py that apply to a checkpoint server — the HTTP
surface, micro-batching, shape buckets, admission control — then the
port's daemon against the JAX daemon on the same weights, and the real
process (``python -m zsgnet_tpu_torch.serve … --device=cpu``) draining an
in-flight request on SIGTERM. Every wait is bounded."""

import base64
import json
import os
import queue
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import cfg_pair, jax_variables
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu.predict import Grounder as JGrounder
from zsgnet_tpu.serve import make_server as j_make_server
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.predict import Grounder
from zsgnet_tpu_torch.serve import MicroBatcher, ServerOverloadedError, load_server_model, make_server
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
QUERIES = ["the red box", "a blue ellipse on the left"]


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    jcfg, tcfg = cfg_pair()
    variables = jax_variables(jcfg, len(Vocab.build(QUERIES)), seed=6)
    g = Grounder(tcfg, Vocab.build(QUERIES), state_dict_from_jax(variables, tcfg), batch_size=2,
                 device="cpu")
    rng = np.random.default_rng(1)
    d = tmp_path_factory.mktemp("imgs")
    Image.fromarray(rng.integers(0, 255, size=(48, 80, 3)).astype(np.uint8)).save(d / "q.png")
    Image.fromarray(rng.integers(0, 255, size=(64, 64, 3)).astype(np.uint8)).save(d / "sq.png")
    srv = make_server(g, port=0, window_ms=20.0)
    url = _start(srv)
    yield g, url, d / "q.png", (jcfg, variables, d / "sq.png")
    srv.shutdown()


def _post(url: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url + "/ground", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


def _same(a: dict, b: dict, atol: float = 1e-4) -> None:
    np.testing.assert_allclose(a["box_xyxy"], b["box_xyxy"], atol=atol)
    np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=1e-5)
    assert abs(a["score"] - b["score"]) < 1e-6


def test_healthz(server):
    _, url, _, _ = server
    meta = _get(url, "/healthz")
    assert meta["ok"] and meta["batch_size"] == 2 and meta["resize_img"] == [64, 64]


def test_path_and_b64_agree_with_grounder(server):
    g, url, img_path, _ = server
    code, via_path = _post(url, {"query": "the red box", "image_path": str(img_path)})
    assert code == 200
    code, via_b64 = _post(url, {"query": "the red box",
                                "image_b64": base64.b64encode(img_path.read_bytes()).decode()})
    assert code == 200
    (direct,) = g.ground([img_path], ["the red box"])
    # Path, bytes and direct decode alike and report original (48 × 80) pixels.
    _same(via_path, direct)
    _same(via_b64, direct)
    assert via_path["box_xyxy"][2] <= 80 + 1e-3 and via_path["box_xyxy"][3] <= 48 + 1e-3


def test_batched_form_and_errors(server):
    g, url, img_path, _ = server
    code, out = _post(url, {"requests": [{"query": q, "image_path": str(img_path)} for q in QUERIES]})
    assert code == 200 and len(out["results"]) == 2
    for served, direct in zip(out["results"], g.ground([img_path] * 2, QUERIES)):
        _same(served, direct)
    code, out = _post(url, {"image_path": str(img_path)})
    assert code == 400 and "query" in out["error"]
    code, out = _post(url, {"query": "x", "image_path": "/nonexistent.png"})
    assert code == 400 and "no such image" in out["error"]
    code, out = _post(url, {"query": "x"})
    assert code == 400 and "image_b64" in out["error"]


def test_multiquery_form(server):
    """One image × N phrases in one shared-backbone pass equals N pairs."""
    g, url, img_path, _ = server
    queries = ["the red box", "a blue ellipse", "the left thing"]
    direct = g.ground([img_path] * 3, queries)
    code, out = _post(url, {"queries": queries, "image_path": str(img_path)})
    assert code == 200 and len(out["results"]) == 3
    for served, d in zip(out["results"], direct):
        _same(served, d)
    code, via_b64 = _post(url, {"queries": queries,
                                "image_b64": base64.b64encode(img_path.read_bytes()).decode()})
    assert code == 200
    for served, d in zip(via_b64["results"], direct):
        _same(served, d)
    code, out = _post(url, {"queries": [], "image_path": str(img_path)})
    assert code == 400 and "queries" in out["error"]
    code, out = _post(url, {"requests": [{"queries": queries, "image_path": str(img_path)}]})
    assert code == 400 and "top-level" in out["error"]


def test_warmup_runs_every_bucket(server):
    g, _, img_path, _ = server
    (before,) = g.ground([img_path], ["the red box"])
    g.warmup(multiquery=True)
    (after,) = g.ground([img_path], ["the red box"])
    assert before == after and len(g.vocab) == len(Vocab.build(QUERIES))


def test_body_size_cap(server):
    g, _, img_path, _ = server
    srv = make_server(g, port=0, window_ms=5.0, max_body_mb=0.0001)  # 100 bytes
    try:
        code, out = _post(_start(srv), {"query": "the red box", "image_path": str(img_path),
                                        "pad": "x" * 200})
        assert code == 413 and "exceeds limit" in out["error"]
    finally:
        srv.shutdown()


def test_statz_counters(server):
    g, url, img_path, _ = server
    code, _ = _post(url, {"query": "the red box", "image_path": str(img_path)})
    assert code == 200
    s = _get(url, "/statz")
    assert s["requests"] >= 1 and s["batches"] >= 1 and 0 < s["mean_batch_fill"] <= g.bs
    assert s["latency"]["p50_ms"] > 0 and s["latency"]["p95_ms"] >= s["latency"]["p50_ms"]
    assert s["uptime_s"] >= 0 and s["batch_size"] == g.bs and s["queue_depth"] == 0


def test_shape_bucketing_matches_full_batch(server):
    """A lone request pads to bucket 1, and grounds as it does padded to the
    full batch (eval-mode BatchNorm: rows do not interact)."""
    g, _, img_path, _ = server
    assert g.bucket_sizes == (1, 2)
    full = Grounder(g.cfg, g.vocab, g.model.state_dict(), batch_size=2, bucket_sizes=(2,), device="cpu")
    assert full.bucket_sizes == (2,)
    (bucketed,) = g.ground([str(img_path)], ["the red box"])
    (padded,) = full.ground([str(img_path)], ["the red box"])
    np.testing.assert_allclose(bucketed["box_xyxy"], padded["box_xyxy"], atol=1e-3)
    assert abs(bucketed["score"] - padded["score"]) < 1e-5


def test_concurrent_requests_coalesce_correctly(server):
    """Six concurrent clients against a 0.5 s window: each gets its own
    answer, and requests share device batches."""
    g, _, img_path, _ = server
    (direct,) = g.ground([img_path], ["the red box"])
    srv = make_server(g, port=0, window_ms=500.0)
    url = _start(srv)
    try:
        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(lambda _: _post(url, {"query": "the red box",
                                                          "image_path": str(img_path)}), range(6)))
        for code, res in results:
            assert code == 200
            _same(res, direct)
        stats = _get(url, "/statz")
        assert stats["requests"] == 6 and stats["batches"] < 6 and stats["mean_batch_fill"] > 1
    finally:
        srv.shutdown()


def test_overload_sheds_fast_with_503(tmp_path):
    """With the device stalled and the queue full, a request gets an
    immediate 503 with Retry-After; draining restores admission."""

    class SlowGrounder:
        bs = 1
        bucket_sizes = (1,)
        cfg = Config(resize_img=(32, 32))

        def __init__(self):
            self.release = threading.Event()
            self.entered = threading.Event()

        def ground(self, images, queries):
            self.entered.set()
            assert self.release.wait(30)
            return [{"box_norm": [0, 0, 0, 0], "box_xyxy": [0, 0, 0, 0], "score": 0.5} for _ in queries]

    g = SlowGrounder()
    srv = make_server(g, port=0, window_ms=1.0, max_queue=2)
    url = _start(srv)
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(tmp_path / "i.png")
    payload = {"query": "x", "image_path": str(tmp_path / "i.png")}
    try:
        with ThreadPoolExecutor(4) as pool:
            f1 = pool.submit(_post, url, payload)  # admitted, stalls in ground()
            assert g.entered.wait(10)
            f2 = pool.submit(_post, url, payload)  # admitted, queued: depth 2 of 2
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and _get(url, "/statz")["queue_depth"] < 2:
                time.sleep(0.05)
            stats = _get(url, "/statz")
            assert stats["queue_depth"] == 2 and stats["max_queue"] == 2
            t0 = time.monotonic()
            req = urllib.request.Request(url + "/ground", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"}, method="POST")
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 503 and err.value.headers["Retry-After"] == "1"
            assert "queue full" in json.loads(err.value.read())["error"]
            assert time.monotonic() - t0 < 5.0  # shed, not parked
            g.release.set()
            assert f1.result(timeout=30)[0] == 200 and f2.result(timeout=30)[0] == 200
        stats = _get(url, "/statz")
        assert stats["shed"] >= 1 and stats["queue_depth"] == 0
        assert _post(url, payload)[0] == 200
    finally:
        g.release.set()
        srv.shutdown()


def test_oversized_request_admitted_on_empty_queue():
    """A multi-query request with more pairs than max_queue is admitted onto
    an empty queue, but not while anything is in flight."""

    class EchoGrounder:
        bs = 8
        bucket_sizes = (1, 8)
        cfg = Config(resize_img=(32, 32))

        def ground_image(self, image, queries):
            return [{"box_norm": [0, 0, 1, 1], "box_xyxy": [0, 0, 1, 1], "score": 0.5} for _ in queries]

        def ground(self, images, queries):
            return self.ground_image(None, queries)

    b = MicroBatcher(EchoGrounder(), window_ms=1.0, max_queue=4)
    img = np.zeros((32, 32, 3), np.uint8)
    assert len(b.wait(b.submit_multi_async(img, ["q"] * 5), timeout=30)) == 5
    with b._stats_lock:
        b._depth += 1  # one pair in flight
    with pytest.raises(ServerOverloadedError):
        b.submit_multi_async(img, ["q"] * 5)
    with b._stats_lock:
        b._depth -= 1
    assert b.submit("img", "q", timeout=30)["score"] == 0.5


def test_port_daemon_matches_jax_daemon(server):
    """The same weights behind both daemons answer the same boxes: a single
    request by path, one by bytes, and a two-pair request list (a 64 × 64
    PNG, which both packages decode to the same pixels)."""
    _, url, _, (jcfg, variables, sq) = server
    jg = JGrounder(jcfg, JVocab.build(QUERIES), variables, batch_size=2)
    jsrv = j_make_server(jg, port=0, window_ms=20.0)
    j_url = _start(jsrv)
    b64 = base64.b64encode(sq.read_bytes()).decode()
    try:
        for payload in ({"query": "the red box", "image_path": str(sq)},
                        {"query": "a blue ellipse", "image_b64": b64}):
            (tc, t), (jc, j) = _post(url, payload), _post(j_url, payload)
            assert tc == jc == 200
            _same(t, j, atol=1e-2)
        pairs = {"requests": [{"query": q, "image_path": str(sq)} for q in QUERIES]}
        (tc, t), (jc, j) = _post(url, pairs), _post(j_url, pairs)
        assert tc == jc == 200
        for a, b in zip(t["results"], j["results"]):
            np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=1e-4)
            assert abs(a["score"] - b["score"]) < 1e-5
    finally:
        jsrv.shutdown()


def test_load_server_model_refuses_unported(server, tmp_path):
    """An artifact directory with ``mesh_spatial`` is refused with the JAX
    daemon's reason, and one that is not a torch.export artifact (the JAX
    package's have no ``format``) by the artifact loader; a checkpoint with
    ``mesh_spatial=2`` serves with the members sharing the CPU, answering as
    the plain Grounder does; and ``data_parallel=True`` serves a checkpoint
    on every local device of the requested type (the CPU's one replica
    here), answering as the plain Grounder does."""
    g, _, img_path, _ = server
    (tmp_path / "export.json").write_text(json.dumps({"version": 1, "batch_size": 2, "platforms": ["cpu"]}))
    with pytest.raises(ValueError, match="mesh_spatial serving needs a checkpoint dir"):
        load_server_model(tmp_path, cfg_overrides={"mesh_spatial": 2}, device="cpu")
    with pytest.raises(ValueError, match="not a torch.export artifact"):
        load_server_model(tmp_path, device="cpu")
    d = _write_checkpoint(g, tmp_path / "ckpt")
    sp = load_server_model(d, batch_size=2, cfg_overrides={"mesh_spatial": 2}, device="cpu")
    assert (sp.spatial, sp.devices) == (2, [torch.device("cpu")] * 2)
    for a, b in zip(sp.ground([img_path] * 2, QUERIES[:2]), g.ground([img_path] * 2, QUERIES[:2])):
        np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=1e-5)
        assert abs(a["score"] - b["score"]) <= 1e-6
    dp = load_server_model(d, batch_size=2, data_parallel=True, device="cpu")
    assert dp.devices == [torch.device("cpu")]
    assert dp.ground([img_path] * 2, QUERIES[:2]) == g.ground([img_path] * 2, QUERIES[:2])
    shutil.rmtree(d)


def _write_checkpoint(g: Grounder, d: Path) -> Path:
    CheckpointManager(d).save(0, {"model": g.model.state_dict(), "best_metric": -1.0})
    (d / "cfg.json").write_text(g.cfg.replace(vocab_size=len(g.vocab)).dumps())
    g.vocab.save(d / "vocab.json")
    return d


def test_daemon_sigterm_drains_inflight_request(server, tmp_path):
    """The real daemon process boots from a checkpoint directory (served
    plainly and spatially in process first), warms its buckets, and answers
    a request already accepted when SIGTERM lands (a 3 s micro-batch window)
    before it exits 0."""
    g, _, img_path, _ = server
    d = _write_checkpoint(g, tmp_path / "ckpt")
    assert load_server_model(d, batch_size=2, device="cpu").ground([img_path], ["the red box"]) == \
        g.ground([img_path], ["the red box"])
    (got,) = load_server_model(d, cfg_overrides={"mesh_spatial": "2"}, device="cpu").ground(
        [img_path], ["the red box"])
    assert abs(got["score"] - g.ground([img_path], ["the red box"])[0]["score"]) <= 1e-6
    proc = subprocess.Popen(
        [sys.executable, "-m", "zsgnet_tpu_torch.serve", str(d), "--port=0", "--batch_size=2",
         "--window_ms=3000", "--device=cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    try:
        lines_q: queue.Queue = queue.Queue()
        reader = threading.Thread(target=lambda: [lines_q.put(ln) for ln in proc.stdout], daemon=True)
        reader.start()
        port, lines = None, []
        deadline = time.time() + 60
        while time.time() < deadline and port is None:
            try:
                line = lines_q.get(timeout=1)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            lines.append(line)
            if line.startswith("serving "):
                port = int(line.split(":")[-1].split()[0].strip("/"))
        assert port, f"daemon never came up:\n{''.join(lines)}"
        assert any(ln.startswith("warmed in") for ln in lines)
        result: dict = {}
        t = threading.Thread(target=lambda: result.update(resp=_post(
            f"http://127.0.0.1:{port}", {"query": "the red box", "image_path": str(img_path)})))
        t.start()
        time.sleep(1.0)  # the request now sits in the 3 s window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=60)
        assert not t.is_alive(), "in-flight request never answered"
        code, res = result["resp"]
        assert code == 200
        _same(res, g.ground([img_path], ["the red box"])[0])
        proc.wait(timeout=60)
        reader.join(timeout=10)
        while not lines_q.empty():
            lines.append(lines_q.get())
        assert proc.returncode == 0, f"exit {proc.returncode}:\n{''.join(lines)}"
        assert "daemon stopped" in "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
