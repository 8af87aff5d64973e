"""The training loop of ``kinds/train.py`` on ``ranks`` cards in data
parallel: one process a card, joined by ``parallel.mesh.init_distributed``
(NCCL between cards, gloo on the CPU; the rendezvous a file store in a
temporary directory), each running ``make_train_step(mesh=...)`` on its own
``batch`` rows of every global batch. The step sums the gradients over the
ranks in bucketed all-reduces, takes the BatchNorm moments over every rank,
and normalizes the loss by the global positive count.

This process coordinates: it starts the ranks, hands each phase to all of
them and takes rank 0's results. Since the program runs in the ranks, each
rank reports the forbidden modules it holds once the window has closed, and
the check refuses the run if any does. The window is a number of steps that every
rank takes alike, set from the warm-up steps' time to last ``--seconds``;
its rate (``train_pairs_per_s.dp4``) counts every rank's pairs over rank 0's
wall time. The reference
runs spread over the same ranks (each its rows, the moments and sums over
the group, ``check.reference_train(group=...)``).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
import traceback

import torch

from benchmark import check, harness
from benchmark.kinds import train

Tensor = torch.Tensor

PHASE_SECONDS = 600  # a rank that answers no phase within this is taken as hung
# Four cards' runs spread far more than one card's, so their rate is an
# end-to-end metric of its own with a bound of its own.
METRIC = "train_pairs_per_s.dp4"


def _phase(run: train.Run, cmd: str, arg):
    rank0 = run.mesh.rank == 0
    if cmd == "build":
        run.build()
        return torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu"
    if cmd == "plant":
        fn, rank = arg
        if rank is None or rank == run.mesh.rank:
            fn(run)
        return None
    if cmd == "prime":
        run.prime()
        run._sync()
        t0 = time.perf_counter()
        for _ in range(2):
            run._next()
        run._sync()
        return (time.perf_counter() - t0) / 2
    if cmd == "window":
        e2e = run.window(*arg)
        return {"e2e": e2e, "win": run.win}
    if cmd == "stretch":
        part = run.stretch()
        tr = part["trace"]
        return part if rank0 else {"busy_s": tr.busy_s, "window_s": tr.window_s}
    if cmd == "peak":
        return torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    if cmd == "check":
        loaded = harness.forbidden_modules(sys.modules)
        readings = run.check()
        return {"loaded": loaded, "readings": readings if rank0 else None}
    if cmd == "calibrate":
        run.release()
        ref = run.reference()
        rows = [{"side": arg["side"], **check.train_readings(run.readings, ref)}]
        if arg.get("control"):
            rows.append({"side": "control_fp8", **check.train_readings(run.reference(conv=check.fp8_conv), ref)})
        return rows if rank0 else None
    raise ValueError(f"unknown phase {cmd!r}")


def _worker(rank: int, world: int, store_dir: str, cfg: dict, traffic: dict, seed: int, conn,
            device_type: str) -> None:
    import torch.distributed as dist

    from zsgnet_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    mesh = init_distributed(dev, store=store, rank=rank, world_size=world)
    run = train.Run(cfg, traffic, seed, dev, mesh=mesh)
    try:
        while True:
            cmd, arg = conn.recv()
            if cmd == "exit":
                break
            conn.send(("ok", _phase(run, cmd, arg)))
    except Exception:  # every phase's failure goes back to the coordinator, which raises it
        conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class Run:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.world = int(traffic["ranks"])
        self.procs: list = []

    def _all(self, cmd: str, arg=None) -> list:
        for c in self.conns:
            c.send((cmd, arg))
        if not all(c.poll(PHASE_SECONDS) for c in self.conns):
            self.close()
            raise RuntimeError(f"a rank gave no answer to {cmd} in {PHASE_SECONDS} s")
        out = [c.recv() for c in self.conns]
        bad = [msg for status, msg in out if status != "ok"]
        if bad:
            self.close()
            raise RuntimeError(f"a rank failed in {cmd}:\n{bad[0]}")
        return [msg for _, msg in out]

    def build(self) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.tmp = tempfile.mkdtemp(prefix="bench_rdv_")
        self.conns = []
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker, args=(r, self.world, self.tmp, self.cfg, self.traffic, self.seed,
                                                  child, self.device.type))
            p.start()
            self.conns.append(parent)
            self.procs.append(p)
        self.device_name = self._all("build")[0]

    def plant(self, fn, rank: int | None = None) -> None:
        """``fn(run)`` in rank ``rank``'s process (every rank's with None),
        ``fn`` a module-level callable: calibration's and the tests' faults."""
        self._all("plant", (fn, rank))

    def prime(self) -> None:
        self.step_s = self._all("prime")[0]

    def window(self, seconds: float) -> dict:
        steps = max(1, round(seconds / self.step_s))
        res = self._all("window", (seconds, steps))[0]
        self.win = res["win"]
        e2e = dict(res["e2e"])
        e2e[METRIC] = e2e.pop("train_pairs_per_s")
        return e2e

    def stretch(self) -> dict:
        parts = self._all("stretch")
        part = parts[0]
        tr = part["trace"]
        busy = [tr.busy_s] + [p["busy_s"] for p in parts[1:]]
        part["busy_s"] = sum(busy) / len(busy)  # averaged over the cards
        return part

    def peak_bytes(self) -> int:
        return max(self._all("peak"))

    def check(self) -> dict[str, float]:
        parts = self._all("check")
        self.close()
        loaded = {f"rank {r}": p["loaded"] for r, p in enumerate(parts) if p["loaded"]}
        if loaded:
            raise SystemExit(f"modules that the benchmark may not load are loaded: {loaded}")
        return parts[0]["readings"]

    def calibrate(self, side: str, control: bool, plant=None) -> list[dict]:
        """Build (with the fault ``plant`` in every rank, where given),
        prime and read this run against the reference (and the control),
        then stop the ranks."""
        self.build()
        if plant is not None:
            self.plant(plant)
        self._all("prime")
        rows = self._all("calibrate", {"side": side, "control": control})[0]
        self.close()
        return rows

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send(("exit", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        self.procs = []
        shutil.rmtree(self.tmp, ignore_errors=True)
