"""What ``run.py`` finds by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic file and the kind of loop that file names,
its limits file, and the readers of its per-layer metrics.

    benchmark/configs/<file named by the configuration's "file">
    benchmark/traffic/<traffic>.json    {"kind": <a module in benchmark/kinds>, ...}
    benchmark/limits/<cell>.json        {<reading>: <limit>, ...}
    benchmark/metrics/<metric>.py       read(record) -> float | None
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zsgnet_tpu")
# Keys of a configuration file that describe it and are not settings.
DESCRIPTIVE = ("source", "reduced", "assumed", "published", "init")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: ModuleType
    limits: dict[str, float]
    end_to_end: list[dict]
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _one(entries: list[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        known = ", ".join(sorted(e["name"] for e in entries))
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json (known: {known})")
    return found[0]


def _file(folder: str, name: str, suffix: str) -> Path:
    path = HERE / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path.relative_to(ROOT)} is missing")
    return path


def reports(metric: dict, cell: str, cell_metrics: set[str] | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or,
    without that key, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return cell_metrics is None or metric.get("moves", metric["name"]) in cell_metrics


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    w = _one(bench["workloads"], name, "workload")
    conf = _one(bench["configs"], w["config"], "configuration")
    config = load_json(ROOT / conf["file"])
    traffic = load_json(_file("traffic", w["traffic"], ".json"))
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    limits = load_json(_file("limits", name, ".json"))
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, kind, limits, e2e, per_layer)


def metric_reader(name: str) -> ModuleType:
    """``benchmark/metrics/<name>.py``, loaded by its path (a metric's name
    may hold dots)."""
    path = _file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_config(cfg: dict, **overrides):
    """The system under test's ``Config`` for a configuration file's settings."""
    from zsgnet_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    settings = {k: v for k, v in cfg.items() if k not in DESCRIPTIVE}
    unknown = set(settings) - fields
    if unknown:
        raise KeyError(f"configuration keys the system does not take: {sorted(unknown)}")
    return Config().replace(**settings, do_dist=False, **overrides)


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})
