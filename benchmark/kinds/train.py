"""Closed loop of training steps: one ``make_train_step`` step object of
the system under test, driven back to back over a ring of seeded batches.

Parameters (the traffic file): ``batch`` pairs a step, ``ring`` distinct
batches, query lengths ``qlen`` [lo, hi] (every length equally often, in
the seed's order), one box a pair with sides drawn in ``box`` [lo, hi]
(normalized frame, width 2), ``checked_steps`` (the first steps, which the
reference follows), ``warm_steps`` more before the window, ``trace_steps``
profiled after it. The ring sits in pinned host memory, as a loader would
hand it over, so each step uploads its batch; decoding and augmentation
are not part of this loop.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import check
from benchmark.weights import make_state

Tensor = torch.Tensor


def make_ring(cfg: dict, traffic: dict, seed: int, rank: int | None = None) -> list[dict[str, np.ndarray]]:
    """``ring`` host batches from ``seed`` (a rank's own rows where ``rank``
    is given): uint8 images, token ids in [2, vocab), lengths, and one tlbr
    box a pair."""
    rng = np.random.default_rng(seed if rank is None else [seed, rank])
    b, n = traffic["batch"], traffic["ring"]
    h, w = cfg["resize_img"]
    lo, hi = traffic["qlen"]
    lens = np.resize(np.arange(lo, hi + 1, dtype=np.int32), b * n)
    rng.shuffle(lens)
    ring = []
    for i in range(n):
        ql = lens[i * b:(i + 1) * b]
        ids = rng.integers(2, cfg["vocab_size"], size=(b, cfg["max_qlen"]), dtype=np.int32)
        ids[np.arange(cfg["max_qlen"])[None, :] >= ql[:, None]] = 0
        side = rng.uniform(*traffic["box"], size=(b, 2))
        centre = rng.uniform(-1.0, 1.0, size=(b, 2)) * (1.0 - side / 2)
        annot = np.concatenate([centre - side / 2, centre + side / 2], axis=1).astype(np.float32)
        img = rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
        ring.append({"img": img, "qvec": ids, "qlens": ql.copy(), "annot": annot})
    return ring


class Run:
    """One cell's program state, window and check. ``build`` makes the step
    object; ``prime`` takes its checked and warm-up steps; ``window`` and
    ``stretch`` drive it; ``check`` frees it and runs the reference."""

    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, mesh=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.mesh = mesh  # a rank of a data-parallel step: its rows of each batch, B a rank
        self.batch = traffic["batch"]
        self.n_done = 0  # steps taken, which picks the next ring batch

    def build(self) -> None:
        from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for
        from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step

        from benchmark.harness import port_config

        m = self.mesh
        sync = {"bn_sync_axis": "data"} if m is not None else {}
        pcfg = port_config(self.cfg, bs=self.batch * (m.world_size if m else 1), **sync)
        self.weights = make_state(self.cfg, self.cfg["vocab_size"], self.seed, self.device)
        with torch.device(self.device):
            model = ZSGNet(pcfg, self.cfg["vocab_size"])
        model.load_state_dict(self.weights)
        self.state = create_train_state(pcfg, model)
        self.step = make_train_step(pcfg, anchor_pyramid_for(pcfg), self.device, mesh=m)
        self.host_ring = make_ring(self.cfg, self.traffic, self.seed, m.rank if m else None)
        pin = self.device.type == "cuda"
        self.ring = [{k: (torch.from_numpy(v).pin_memory() if pin and k != "qlens" else torch.from_numpy(v))
                      for k, v in b.items()} for b in self.host_ring]

    def _next(self) -> Tensor:
        _, ls = self.step(self.state, self.ring[self.n_done % len(self.ring)])
        self.n_done += 1
        return ls["total"]

    def prime(self) -> None:
        """The checked steps, read as the reference will be: the first
        step's box deltas (a host copy), each loss, the first gradient from
        Adam's state, the change after the last; then the warm-up steps."""
        named = [(n, p) for n, p in self.state.model.named_parameters() if p.requires_grad]
        start = [p.detach().clone() for _, p in named]
        outs: dict[str, Tensor] = {}

        def keep(_module, _args, out):
            outs.setdefault("bbx", out["bbx_out"].detach().to("cpu"))

        hook = self.state.model.register_forward_hook(keep)
        losses = []
        for i in range(self.traffic["checked_steps"]):
            losses.append(self._next())
            hook.remove()
            if i == 0:
                opt = self.state.optimizer.state
                grads = [opt[p]["exp_avg"] / (1 - check.BETA1) if p in opt else torch.zeros_like(p)
                         for _, p in named]
                grad = check.norms(grads)
                del grads
        change = check.norms([p.detach() - s for (_, p), s in zip(named, start)])
        del start
        self.readings = {"loss": [float(x) for x in losses],
                         "grad": dict(zip((n for n, _ in named), grad)), "out_t": outs,
                         "change": dict(zip((n for n, _ in named), change))}
        for _ in range(self.traffic["warm_steps"]):
            self._next()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, steps: int | None = None) -> dict:
        """Steps back to back until ``seconds`` have passed on the host (or
        ``steps`` of them, which every rank of a mesh takes alike), then a
        synchronize: every step over all the time."""
        self._sync()
        t0 = time.perf_counter()
        losses = []
        while True:
            losses.append(self._next())
            if (len(losses) >= steps) if steps else (time.perf_counter() - t0 >= seconds):
                break
        self._sync()
        wall = time.perf_counter() - t0
        finite = int(torch.isfinite(torch.stack(losses)).sum())
        world = self.mesh.world_size if self.mesh is not None else 1
        self.win = {"s": wall, "steps": len(losses), "pairs": len(losses) * self.batch * world}
        return {"attempted": len(losses), "failed": len(losses) - finite,
                "train_pairs_per_s": self.win["pairs"] / wall}

    def stretch(self) -> dict:
        """``trace_steps`` more steps under the profiler → the record's part."""
        from benchmark.trace import profiled

        first = self.n_done
        n = self.traffic["trace_steps"]
        trace = profiled(lambda: [self._next() for _ in range(n)])
        gts = [self.host_ring[(first + i) % len(self.ring)]["annot"] for i in range(n)]
        world = self.mesh.world_size if self.mesh is not None else 1
        return {"trace": trace, "stretch": {"steps": n, "pairs": n * self.batch * world, "annot": gts}}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.state, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, conv=None) -> dict:
        batches = [{k: v.to(self.device) for k, v in b.items()}
                   for b in self.ring[: self.traffic["checked_steps"]]]
        return check.reference_train(self.cfg, self.weights, batches, self.traffic["checked_steps"], conv,
                                     self.mesh.group if self.mesh is not None else None)

    def check(self) -> dict[str, float]:
        self.release()
        return check.train_readings(self.readings, self.reference())
