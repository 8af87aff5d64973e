"""Closed loop of grounding clients through the serving batcher.

``clients`` clients each keep one request in flight: a pre-decoded uint8
image (one of ``images`` seeded ones at the configuration's size) and a
query of ``qlen`` [lo, hi] words from the vocabulary (every length equally
often, in the seed's order). A client sends its next request as soon as its
answer arrives. The system under test is ``serve.MicroBatcher`` (window
``window_ms``) over ``predict.Grounder(batch_size)``, entered through
``submit_async`` and ``wait`` as the daemon's handlers enter it; one client
thread stands for all clients and waits on their requests in the order
sent, which is the order the batcher answers them. Latency is taken on the
client's side, from before the submit to the return of ``wait``.
"""

from __future__ import annotations

import gc
import time
from collections import deque

import numpy as np
import torch

from benchmark import check
from benchmark.reference import model as ref_model
from benchmark.weights import make_state

Tensor = torch.Tensor

REQUESTS = 1 << 17  # the seeded request list; a longer run cycles through it


def make_requests(cfg: dict, traffic: dict, seed: int) -> dict[str, np.ndarray]:
    """The seeded images and request list: ``img`` (images, H, W, 3) uint8,
    ``image`` (R,) each request's image, ``qlen`` (R,), ``words`` (R, hi) ids."""
    rng = np.random.default_rng(seed)
    h, w = cfg["resize_img"]
    lo, hi = traffic["qlen"]
    lens = np.resize(np.arange(lo, hi + 1, dtype=np.int32), REQUESTS)
    rng.shuffle(lens)
    return {"img": rng.integers(0, 256, size=(traffic["images"], h, w, 3), dtype=np.uint8),
            "image": rng.integers(0, traffic["images"], size=REQUESTS),
            "qlen": lens,
            "words": rng.integers(2, cfg["vocab_size"], size=(REQUESTS, hi), dtype=np.int32)}


def vocab_words(n: int) -> list[str]:
    """Word i of the benchmark's vocabulary (ids 0 and 1 are padding and unknown)."""
    return ["<pad>", "<unk>"] + [f"w{i}" for i in range(2, n)]


class Run:
    kind = "ground"
    readings_names = ("anchor_gap", "score_gap", "box_gap", "anchor_gap_mean", "score_gap_mean",
                      "box_gap_mean", "flip_share", "missed_share", "box_rel", "box_rel_bf16", "box_ratio")

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.sent = 0
        self.pending: deque = deque()
        self.done: list[tuple[int, float, float, dict | None]] = []  # (request, sent, answered, answer)

    def build(self) -> None:
        from zsgnet_tpu_torch.data.vocab import Vocab
        from zsgnet_tpu_torch.predict import Grounder

        from benchmark.harness import port_config

        t = self.traffic
        self.weights = make_state(self.cfg, self.cfg["vocab_size"], self.seed, self.device)
        self.words = vocab_words(self.cfg["vocab_size"])
        vocab = Vocab({w: i for i, w in enumerate(self.words)})
        self.grounder = Grounder(port_config(self.cfg), vocab, self.weights, batch_size=t["batch_size"],
                                 device=self.device, quantize=t.get("quantize", False))
        self.req = make_requests(self.cfg, t, self.seed)

    def prime(self) -> None:
        """Every bucket once, the batcher started, then the loop for
        ``warm_s`` seconds."""
        from zsgnet_tpu_torch.serve import MicroBatcher

        self.grounder.warmup()
        self.batcher = MicroBatcher(self.grounder, window_ms=self.traffic["window_ms"])
        for _ in range(self.traffic["clients"]):
            self._send()
        self._loop(time.perf_counter() + self.traffic["warm_s"])
        self.warm_answers = len(self.done)

    def _query(self, r: int) -> str:
        i = r % REQUESTS
        return " ".join(self.words[k] for k in self.req["words"][i, : self.req["qlen"][i]])

    def _send(self) -> None:
        r = self.sent
        img = self.req["img"][self.req["image"][r % REQUESTS]]
        t = time.perf_counter()
        self.pending.append((r, t, self.batcher.submit_async(img, self._query(r))))
        self.sent += 1

    def _answer(self) -> float:
        r, t_sent, item = self.pending.popleft()
        try:
            res = self.batcher.wait(item, timeout=300.0)
        except (RuntimeError, TimeoutError):
            res = None
        t = time.perf_counter()
        self.done.append((r, t_sent, t, res))
        return t

    def _loop(self, until: float) -> None:
        """Answer and resend until an answer comes at or after ``until``;
        then take the rest of that answer's batch, already set."""
        while True:
            t = self._answer()
            self._send()
            if t >= until:
                break
        while self.pending and self.pending[0][2].event.is_set():
            self._answer()
            self._send()

    def window(self, seconds: float) -> dict:
        """From one batch's answers to the first batch answered ``seconds``
        later: every request answered in between, its latency client-side."""
        self._loop(0.0)  # start on a batch boundary
        t0 = self.done[-1][2]
        s0 = self.batcher.stats()
        first = len(self.done)
        self._loop(t0 + seconds)
        s1 = self.batcher.stats()
        t1 = self.done[-1][2]
        rows = self.done[first:]
        lat = np.array([(t - ts) if res is not None else np.inf for _, ts, t, res in rows])
        failed = int(np.isinf(lat).sum())
        self.win = {"s": t1 - t0, "pairs": len(rows) - failed, "first": first, "last": len(self.done),
                    "batches": s1["batches"] - s0["batches"], "fill": fill_sum(s1) - fill_sum(s0),
                    "p50_ms": float(np.percentile(lat, 50)) * 1e3, "p95_ms": float(np.percentile(lat, 95)) * 1e3}
        return {"attempted": len(rows), "failed": failed,
                "ground_pairs_per_s": self.win["pairs"] / self.win["s"], "ground_p95_ms": self.win["p95_ms"]}

    def stretch(self) -> dict:
        """The loop for ``trace_s`` more seconds under the profiler."""
        from benchmark.trace import profiled

        s0, first = self.batcher.stats(), len(self.done)
        trace = profiled(lambda: self._loop(time.perf_counter() + self.traffic["trace_s"]))
        s1 = self.batcher.stats()
        return {"trace": trace, "stretch": {"pairs": len(self.done) - first,
                                            "batches": s1["batches"] - s0["batches"]}}

    def release(self) -> None:
        """Answer every request still in flight, then free the program."""
        while self.pending:
            self._answer()
        del self.batcher, self.grounder
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[int]:
        """Indices into ``done`` of ``sample`` answers of the window, drawn
        from the seed, with a longest query among them."""
        rows = np.arange(self.win["first"], self.win["last"])
        rng = np.random.default_rng(self.seed + 1)
        pick = rng.choice(rows, size=min(self.traffic["sample"], len(rows)), replace=False)
        qlen = self.req["qlen"][[self.done[i][0] % REQUESTS for i in rows]]
        longest = rows[int(np.argmax(qlen))]
        return sorted(set(pick.tolist()) | {int(longest)})

    def reference_inputs(self, picks: list[int]) -> dict[str, Tensor]:
        req = [self.done[i][0] % REQUESTS for i in picks]
        qvec = np.zeros((len(req), self.cfg["max_qlen"]), np.int64)
        for j, r in enumerate(req):
            n = self.req["qlen"][r]
            qvec[j, :n] = self.req["words"][r, :n]
        return {"img": torch.from_numpy(self.req["img"][self.req["image"][req]]).to(self.device),
                "qvec": torch.from_numpy(qvec).to(self.device),
                "qlens": torch.from_numpy(self.req["qlen"][req].astype(np.int64))}

    def check(self) -> dict[str, float]:
        self.release()
        picks = self.sample()
        answers = [self.done[i][3] for i in picks]
        if any(a is None for a in answers):
            return {k: float("inf") for k in self.readings_names}
        x = self.reference_inputs(picks)
        att, boxes = check.reference_ground(self.cfg, self.weights, x["img"], x["qvec"], x["qlens"])
        _, boxes_bf16 = check.reference_ground(self.cfg, self.weights, x["img"], x["qvec"], x["qlens"],
                                               conv=check.bf16_conv)
        served_box = torch.tensor([a["box_norm"] for a in answers], dtype=torch.float32, device=self.device)
        served_score = torch.tensor([a["score"] for a in answers], dtype=torch.float32, device=self.device)
        anchors = ref_model.anchors(self.cfg, torch.float32).to(self.device)
        return check.ground_readings(att, boxes, served_box, served_score, anchors, boxes_bf16)


def fill_sum(stats: dict) -> float:
    """Pairs in all device batches so far, from the batcher's counters."""
    return (stats["mean_batch_fill"] or 0.0) * stats["batches"]
