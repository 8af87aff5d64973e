"""What ptxas reports for the package's CUDA kernels: registers, spills,
stack and static shared memory of every kernel, and its warnings.

    python -m zsgnet_tpu_torch.tools.ptxas_info

Builds ``csrc/*.cu`` with ``-Xptxas -v`` (into ``build/torch_kernels/``, beside
the libraries of a plain build) and prints one line per kernel; needs
``nvcc`` and no GPU. ``report`` returns the same rows.
"""

from __future__ import annotations

import re
import subprocess
import sys

NAMES = ("fused_loss", "fused_bottleneck")


def _demangle(symbols: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt", *symbols], capture_output=True, text=True, check=True).stdout
        return [line.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                for line in out.splitlines()]
    except (OSError, subprocess.CalledProcessError):
        return symbols


def report(name: str) -> tuple[list[dict], list[str]]:
    """(rows, warnings) for ``csrc/<name>.cu``: a row per kernel with its
    registers, spill stores and loads, stack frame and static shared memory."""
    from zsgnet_tpu_torch.ops.cuda import build

    rows, warnings, cur = [], [], None
    for line in build.ptxas_report(name).splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": 0, "spill_loads": 0,
                   "stack": 0, "smem": 0}
            rows.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
                                                 r"bytes spill loads", line)):
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            if s := re.search(r"(\d+) bytes smem", line):
                cur["smem"] = int(s.group(1))
        elif "warning" in line.lower() or re.search(r"\(C\d+\)", line):
            warnings.append(line.strip())
    for row, nice in zip(rows, _demangle([r["kernel"] for r in rows])):
        row["kernel"] = nice
    return rows, warnings


def main() -> int:
    for name in NAMES:
        rows, warnings = report(name)
        print(f"{name}.cu")
        for r in rows:
            print(f"  {r['kernel']}: {r['registers']} registers, spill {r['spill_stores']}/{r['spill_loads']} "
                  f"bytes stored/loaded, stack {r['stack']}, static shared {r['smem']}")
        for w in warnings:
            print(f"  ptxas: {w[:300]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
