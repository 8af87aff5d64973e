"""Readings from which a cell's limits are set: the program's sound runs,
the lower-precision control in the program's place, and planted faults,
each over its own seeds, one JSON line a reading.

    python -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds 3]

Training cells read the first three steps only (no window): the program's
step object against the reference; the reference with float8 convolutions
(``check.fp8_conv``) against the reference; and the program fed half of
every batch (the loss is then the mean over the other half), and on a
data-parallel cell the program with its gradients' exchange left out. A state
left unchanged reads 1 on ``grad_gap`` and ``change_gap`` by construction
and is not run. Grounding cells run a short window of the cell's own load
per seed: the program; the program's own int8 path (``quantize``) as the
control; each answer handed to the next request of its batch; and the
score logits negated where the model produces them (the decode then takes
the worst anchor, and the score is another anchor's).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from benchmark import check, harness


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def plant(run, fault: str | None) -> None:
    """A fault in the timed path of a built run: ``half_batch`` (the step
    sees the first half of each batch's rows), ``unchanged`` (the optimizer
    leaves the state as it was), ``no_exchange`` (a data-parallel step's
    gradient all-reduce left out), ``shifted_answers`` (each request of a
    device batch gets the next one's answer), ``negated_scores`` (the
    model's score logits negated as it returns them)."""
    if fault == "half_batch":
        step = run.step
        run.step = lambda state, b: step(state, {k: v[: v.shape[0] // 2] for k, v in b.items()})
    elif fault == "unchanged":
        run.state.optimizer.step = lambda *a, **k: None
    elif fault == "no_exchange":
        import zsgnet_tpu_torch.parallel.train_step as ts

        ts.all_reduce_sum_ = lambda tensors, group: None
    elif fault == "shifted_answers":
        ground = run.grounder.ground

        def shifted(images, queries):
            out = ground(images, queries)
            return out[1:] + out[:1]

        run.grounder.ground = shifted
    elif fault == "negated_scores":
        for model, _ in run.grounder.replicas:
            model.register_forward_hook(lambda _m, _a, out: {**out, "att_out": -out["att_out"]})
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")


def train_seed(cell: harness.Cell, seed: int, device, control: bool, fault: bool) -> list[dict]:
    rows = []
    run = cell.kind.Run(cell.config, cell.traffic, seed, device)
    run.build()
    run.prime()
    run.release()
    ref = run.reference()
    rows.append({"side": "program", "seed": seed, **check.train_readings(run.readings, ref)})
    if control:
        rows.append({"side": "control_fp8", "seed": seed,
                     **check.train_readings(run.reference(conv=check.fp8_conv), ref)})
    if fault:
        bad = cell.kind.Run(cell.config, cell.traffic, seed, device)
        bad.build()
        plant(bad, "half_batch")
        bad.prime()
        bad.release()
        rows.append({"side": "fault_half_batch", "seed": seed, **check.train_readings(bad.readings, ref)})
    return rows


def dp_seed(cell: harness.Cell, seed: int, device, control: bool, fault: bool) -> list[dict]:
    """As :func:`train_seed` over the ranks of a data-parallel cell, with
    the exchange between the cards left out as one more fault."""
    rows = cell.kind.Run(cell.config, cell.traffic, seed, device).calibrate("program", control)
    for f in ("no_exchange", "half_batch") if fault else ():
        run = cell.kind.Run(cell.config, cell.traffic, seed, device)
        rows += run.calibrate(f"fault_{f}", False, plant=functools.partial(plant, fault=f))
    return [{**r, "seed": seed} for r in rows]


def ground_seed(cell: harness.Cell, seed: int, device, seconds: float, side: str) -> dict:
    traffic = dict(cell.traffic, quantize=True) if side == "control_int8" else cell.traffic
    run = cell.kind.Run(cell.config, traffic, seed, device)
    run.build()
    if side.startswith("fault_"):
        plant(run, side[len("fault_"):])
    run.prime()
    win = run.window(seconds)
    return {"side": side, "seed": seed, "pairs_per_s": win["ground_pairs_per_s"], **run.check()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds)):
        t = time.perf_counter()
        if cell.traffic["kind"] == "train_dp":
            rows = dp_seed(cell, seed, device, seed in args.control_seeds, seed in args.fault_seeds)
        elif cell.kind.Run.kind == "train":
            rows = train_seed(cell, seed, device, seed in args.control_seeds, seed in args.fault_seeds)
        else:
            sides = [s for s, pick in (("program", args.seeds), ("control_int8", args.control_seeds),
                                       ("fault_shifted_answers", args.fault_seeds),
                                       ("fault_negated_scores", args.fault_seeds)) if seed in pick]
            rows = [ground_seed(cell, seed, device, args.seconds, s) for s in sides]
        for r in rows:
            r["s"] = time.perf_counter() - t
            print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
