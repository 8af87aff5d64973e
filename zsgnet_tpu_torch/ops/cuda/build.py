"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout (listed in
``.gitignore``) and loaded with ``ctypes``. The library's file name holds
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is. Nothing is compiled when a module is
imported: the CPU tests import every module on machines without ``nvcc``.

:func:`ptxas_report` builds a source once more with ``-Xptxas -v`` and
returns the compiler's report (registers, spills, shared memory of every
kernel); ``zsgnet_tpu_torch.tools.ptxas_info`` prints it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "--split-compile=0",  # ptxas over a file's kernels in parallel (nvcc 12.1 or newer): half the build time
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")
    return str(path)


def _compile(name: str, extra: tuple[str, ...] = ()) -> Path:
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *extra)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".nvcc.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return lib


def ptxas_report(name: str) -> str:
    """What nvcc prints when it builds ``csrc/<name>.cu`` with ``-Xptxas -v``:
    ptxas's resource lines for every kernel, and its warnings. The library of
    that build is kept apart from the one :func:`load` uses."""
    return _compile(name, ("-Xptxas", "-v")).with_suffix(".nvcc.txt").read_text()


def load(name: str, extra: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, compiling it first
    if needed. Different names build concurrently from different threads.
    ``extra`` nvcc flags (a ``-D`` that turns on a source's instrumentation)
    give a library of their own."""
    key = " ".join((name, *extra))
    with _lock:
        name_lock = _name_locks.setdefault(key, threading.Lock())
    with name_lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(_compile(name, extra)))
        return _libs[key]


def load_all(names: list[str]) -> dict[str, ctypes.CDLL]:
    """Build and load several kernel libraries, one nvcc for each, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(load, names)))
