"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the system under test; top-level module names
are compared whole (``zsgnet_tpu_torch`` is not ``zsgnet_tpu``)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in harness.HERE.rglob("*.py") if "tests" not in p.relative_to(harness.HERE).parts]
    assert len(files) > 10
    for p in files:
        assert not _imports(p) & set(harness.FORBIDDEN), p
    for p in (harness.HERE / "reference").rglob("*.py"):
        assert not _imports(p) & {"zsgnet_tpu_torch", *harness.FORBIDDEN}, p


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(["zsgnet_tpu_torch", "zsgnet_tpu_torch.predict", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "zsgnet_tpu.models", "flax"]) == \
        ["flax", "jax.numpy", "zsgnet_tpu.models"]


def test_a_cpu_run_loads_no_jax():
    code = ("import sys, torch\n"
            "from benchmark import run\n"
            "from benchmark.tests.small import CPU, small_cell\n"
            "import time\n"
            "res = run.execute(small_cell('ssd300.train.b128'), 5, 0.5, False, CPU, time.perf_counter())\n"
            "from benchmark import harness\n"
            "print(harness.forbidden_modules(sys.modules), res['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=harness.ROOT,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(harness.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
