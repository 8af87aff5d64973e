"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: load the program and make the weights and inputs from the seed,
warm up the cell's own shapes (all of this is ``setup_s``), measure for
``--seconds``, with ``--trace 1`` profile a short stretch after the window,
then free the program and compare what the timed path produced with the
plain reference. Earlier lines of standard output give the card's name and
power limit and the window's detail; the last lines of standard error give
each compared number beside its limit; the last line of standard output is
the result, a JSON object. Without a CUDA device, or with fewer than the
cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from benchmark import check, counts, harness  # noqa: E402


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def execute(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
            t_start: float, wrap=None) -> dict:
    """One run of ``cell`` → the result object. ``wrap(run)``, when given,
    is called between building the program and its first step (the tests
    plant faults there)."""
    run = cell.kind.Run(cell.config, cell.traffic, seed, device)
    t_build = time.perf_counter()
    run.build()
    if wrap is not None:
        wrap(run)
    t_prime = time.perf_counter()
    run.prime()
    setup_s = time.perf_counter() - t_start
    print(f"# setup: {setup_s} s: {t_build - t_start} s to load, {t_prime - t_build} s to build, "
          f"{t_start + setup_s - t_prime} s of first steps and warm-up", flush=True)
    e2e = run.window(seconds)
    cuda = device.type == "cuda"
    if hasattr(run, "device_name"):  # the ranks' card; this process holds none
        kind = run.device_name
    else:
        kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips}
    e2e_units = {m["name"]: m["unit"] for m in cell.end_to_end}
    values = {**e2e, "setup_s": setup_s}
    metrics = {n: {"value": values[n], "unit": u} for n, u in e2e_units.items()}
    print(f"# window: {json.dumps(run.win)}", flush=True)
    breakdown = None
    if trace:
        part = run.stretch()
        record = {"kind": run.kind, "cfg": cell.config, "traffic": cell.traffic, "window": run.win,
                  "peaks": counts.PEAKS.get(kind), "chips": cell.chips, **part}
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = part["trace"]
        dev.update(busy_s=part.get("busy_s", tr.busy_s), window_s=tr.window_s)
        breakdown = tr.breakdown()
        counted = {k: v for k, v in part["stretch"].items() if isinstance(v, (int, float))}
        print(f"# stretch: {json.dumps(counted)}, busy {tr.busy_s} s of {tr.window_s} s", flush=True)
    if hasattr(run, "peak_bytes"):  # the fullest of the cards that other processes drive
        dev["memory_peak_bytes"] = run.peak_bytes()
    else:
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    # A kind whose program runs in processes of its own looks in theirs in ``run.check()``.
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        raise SystemExit(f"modules that the benchmark may not load are loaded: {loaded}")
    readings = run.check()
    correct, table = check.verdict(readings, cell.limits)
    out = {"correct": correct, "attempted": e2e["attempted"], "failed": e2e["failed"],
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = table
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {n} available", file=sys.stderr)
        return 2
    print(f"# card: {card_line()}", flush=True)
    if cell.chips == 1:
        torch.cuda.set_device(0)
    res = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    for name, row in res["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
