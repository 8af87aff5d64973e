"""ctypes binding for the host image pipeline (``csrc/zsg_image.cpp``).

Port of the JAX package's native binding, over the port's own copy of the
C++ source. The library is built with ``g++ -O3 -fPIC -shared`` at first
use, never at import, into ``build/native/`` at the root of the checkout
(git-ignored), under a name that hashes the source and the build command,
and rebuilt when the source is newer than it. JPEG decode
(``-DZSG_USE_JPEG -ljpeg``) is compiled in when ``/usr/include/jpeglib.h``
exists; PIL links the same libjpeg, so the two paths give the same bytes.

A build that fails is not hidden: :func:`status` returns the reason, and
the first use prints it once to standard error. The callers in
``data/dataset.py`` then decode with PIL, as they do file by file for a
format the library does not take (16-bit or interlaced PNG, other
formats): every entry point returns None for those.

:func:`counts` tells how many whole files were decoded natively and how
many through PIL since :func:`reset_counts`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "zsg_image.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
JPEG_HEADER = Path("/usr/include/jpeglib.h")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_status: str | None = None  # None until the first load attempt
_counts = {"native": 0, "pil": 0}

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "zsg_png_load": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                     _F32P, _F32P, _F32P, _INTP, _INTP],
    "zsg_image_load": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                       _F32P, _F32P, _F32P, _INTP, _INTP],
    "zsg_png_load_u8": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                        _U8P, _INTP, _INTP],
    "zsg_image_load_u8": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                          _U8P, _INTP, _INTP],
    "zsg_resize_normalize_rgb": [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 _F32P, _F32P, _F32P],
    "zsg_resize_u8": [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P],
    "zsg_has_jpeg": [],
}


def build_command(out: Path) -> list[str]:
    """The compiler command that builds the library into ``out``."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    cmd = [cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", str(out), str(SOURCE), "-lz"]
    if JPEG_HEADER.exists():
        cmd[1:1] = ["-DZSG_USE_JPEG"]
        cmd.append("-ljpeg")
    return cmd


def lib_path() -> Path:
    """The library's path: its name holds a hash of the source and of the
    build command, so a machine with other headers (no libjpeg) or an edited
    source gets a library of its own."""
    key = SOURCE.read_bytes() + " ".join(build_command(Path("out"))).encode()
    return BUILD_DIR / f"libzsgimage-{hashlib.sha256(key).hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(build_command(path))} failed:\n{proc.stderr.strip()}")
    os.replace(tmp, path)  # atomic: another process never loads a partial file


def _load() -> ctypes.CDLL | None:
    global _lib, _status
    if _status is not None:
        return _lib
    with _lock:
        if _status is not None:
            return _lib
        try:
            path = lib_path()
            if not path.exists() or path.stat().st_mtime < SOURCE.stat().st_mtime:
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:  # built elsewhere against libraries this machine lacks
                _build(path)
                lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = ctypes.c_int, argtypes
            _lib = lib
            _status = f"loaded {path}, " + ("with JPEG" if lib.zsg_has_jpeg() else "PNG-only (no libjpeg)")
        except Exception as e:  # noqa: BLE001 — kept and reported, PIL decodes instead
            _status = f"unavailable: {e}"
            print(f"zsgnet_tpu_torch.data.native: {_status}; decoding with PIL", file=sys.stderr, flush=True)
    return _lib


def status() -> str:
    """How the library stands: loaded (with or without JPEG), or the reason
    it is unavailable. Loads it first if no call has yet."""
    _load()
    return str(_status)


def available() -> bool:
    return _load() is not None


def has_jpeg() -> bool:
    """True when the compiled library carries libjpeg decode."""
    lib = _load()
    return bool(lib is not None and lib.zsg_has_jpeg())


def record(kind: str) -> None:
    """Count one whole-file decode, ``"native"`` or ``"pil"``."""
    with _lock:
        _counts[kind] += 1


def counts() -> dict[str, int]:
    """Whole-file decodes since :func:`reset_counts`, by path."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0


def _rgb(rgb: np.ndarray) -> np.ndarray:
    """``rgb`` as the C side reads it: contiguous (h, w, 3) uint8."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"expected a non-empty (h, w, 3) image, got shape {rgb.shape}")
    return rgb


def _decode(fn_name: str, data: bytes, out: np.ndarray, *norm) -> tuple[np.ndarray, tuple[int, int]] | None:
    lib = _load()
    if lib is None:
        return None
    oh, ow = out.shape[:2]
    orig_h, orig_w = ctypes.c_int(0), ctypes.c_int(0)
    ptr = _F32P if out.dtype == np.float32 else _U8P
    rc = getattr(lib, fn_name)(
        data, len(data), oh, ow, *norm, out.ctypes.data_as(ptr), ctypes.byref(orig_h), ctypes.byref(orig_w),
    )
    if rc != 0:
        return None
    record("native")
    return out, (orig_h.value, orig_w.value)


def _mean_std(mean: np.ndarray, std: np.ndarray) -> tuple:
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    # The arrays travel with their pointers so they outlive the call.
    return (mean32, std32), (mean32.ctypes.data_as(_F32P), std32.ctypes.data_as(_F32P))


def image_load(
    img_bytes: bytes, out_hw: tuple[int, int], mean: np.ndarray, std: np.ndarray
) -> tuple[np.ndarray, tuple[int, int]] | None:
    """PNG/JPEG bytes (format sniffed) → (normalized float32 (H, W, 3),
    original (h, w)), or None when the library cannot take this file."""
    _keep, ptrs = _mean_std(mean, std)
    return _decode("zsg_image_load", img_bytes, np.empty((*map(int, out_hw), 3), np.float32), *ptrs)


def image_load_u8(
    img_bytes: bytes, out_hw: tuple[int, int]
) -> tuple[np.ndarray, tuple[int, int]] | None:
    """PNG/JPEG bytes (format sniffed) → (resized uint8 (H, W, 3), original
    (h, w)), or None."""
    return _decode("zsg_image_load_u8", img_bytes, np.empty((*map(int, out_hw), 3), np.uint8))


def png_load(
    png_bytes: bytes, out_hw: tuple[int, int], mean: np.ndarray, std: np.ndarray
) -> tuple[np.ndarray, tuple[int, int]] | None:
    """PNG bytes → (normalized float32 (H, W, 3), original (h, w)), or None."""
    _keep, ptrs = _mean_std(mean, std)
    return _decode("zsg_png_load", png_bytes, np.empty((*map(int, out_hw), 3), np.float32), *ptrs)


def png_load_u8(
    png_bytes: bytes, out_hw: tuple[int, int]
) -> tuple[np.ndarray, tuple[int, int]] | None:
    """PNG bytes → (resized uint8 (H, W, 3), original (h, w)), or None."""
    return _decode("zsg_png_load_u8", png_bytes, np.empty((*map(int, out_hw), 3), np.uint8))


def resize_u8(rgb: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray | None:
    """(h, w, 3) uint8 → resized uint8 (H, W, 3) (Pillow bilinear), or None."""
    lib = _load()
    if lib is None:
        return None
    rgb = _rgb(rgb)
    out = np.empty((*map(int, out_hw), 3), np.uint8)
    rc = lib.zsg_resize_u8(rgb.ctypes.data_as(_U8P), rgb.shape[0], rgb.shape[1],
                           out.shape[0], out.shape[1], out.ctypes.data_as(_U8P))
    return out if rc == 0 else None


def resize_normalize_rgb(
    rgb: np.ndarray, out_hw: tuple[int, int], mean: np.ndarray, std: np.ndarray
) -> np.ndarray | None:
    """(h, w, 3) uint8 → normalized float32 (H, W, 3), or None: the
    resample and normalize stage after a PIL decode."""
    lib = _load()
    if lib is None:
        return None
    rgb = _rgb(rgb)
    out = np.empty((*map(int, out_hw), 3), np.float32)
    _keep, ptrs = _mean_std(mean, std)
    rc = lib.zsg_resize_normalize_rgb(rgb.ctypes.data_as(_U8P), rgb.shape[0], rgb.shape[1],
                                      out.shape[0], out.shape[1], *ptrs, out.ctypes.data_as(_F32P))
    return out if rc == 0 else None
