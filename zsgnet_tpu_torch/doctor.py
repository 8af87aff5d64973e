"""Environment self-check: ``python -m zsgnet_tpu_torch.doctor``. Port of
``zsgnet_tpu/doctor.py``.

Answers "will this machine run the port, and with what?" before a run
finds out the hard way. Checks run in dependency order and never hang: the
CUDA device probe and the kernels' build run on a daemon thread with a
deadline and report a timeout instead of blocking.

    python -m zsgnet_tpu_torch.doctor [--device=cpu] [--timeout=60] [--smoke=false]

Required rows: the versions (torch with its CUDA version, numpy, PIL,
pandas), the config, the scratch directory, the CUDA device (name,
capability, count), the kernels' build (``nvcc`` for ``sm_90a``, every
``csrc/*.cu``) and the smoke test (a 256² bf16 matmul summed in float32,
and one launch of the fused-loss kernel K1 held against its plain
version). Optional rows print their state and fail nothing: the native
image pipeline, tensorboardX, the device count and the nvcc arch. With
``--device=cpu`` the device, build and K1 rows are skipped and the
matmul runs on the CPU. Exit code 0 when every required row passes, else
1; the doctor never ends in a stack trace.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

_OK = "  ok  "
_BAD = " FAIL "
_OPT = " info "
KERNELS = ["fused_loss", "fused_bottleneck"]


def _row(status: str, name: str, detail: str = "") -> None:
    print(f"[{status}] {name:32s} {detail}", flush=True)


def _watchdog(fn, timeout_s: float):
    """(result, None), (None, exception), or (None, None) when ``fn`` is
    still running at the deadline (its daemon thread is left behind)."""
    box: dict = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # noqa: BLE001 — reported to the caller
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    return box.get("out"), box.get("err")


def _versions() -> bool:
    import importlib

    good = True
    _row(_OK, "python", sys.version.split()[0])
    try:
        import torch

        _row(_OK, "torch", f"{torch.__version__} (CUDA {torch.version.cuda})")
    except Exception as e:  # noqa: BLE001
        _row(_BAD, "torch", f"import failed: {e}")
        good = False
    for mod in ("numpy", "PIL", "pandas"):
        try:
            _row(_OK, mod, getattr(importlib.import_module(mod), "__version__", "?"))
        except Exception as e:  # noqa: BLE001
            _row(_BAD, mod, f"import failed: {e}")
            good = False
    return good


def _config() -> bool:
    try:
        from zsgnet_tpu_torch.config import get_default_cfg

        cfg = get_default_cfg()
        _row(_OK, "config", f"model={cfg.mdl_to_use} resize={cfg.resize_img} dtype={cfg.compute_dtype}")
        return True
    except Exception as e:  # noqa: BLE001
        _row(_BAD, "config", f"{e}")
        return False


def _scratch() -> bool:
    try:
        from zsgnet_tpu_torch.config import get_default_cfg

        tmp = get_default_cfg().tmp_path
        os.makedirs(tmp, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=tmp, prefix="doctor_"):
            pass
        _row(_OK, "scratch dir (cfg.tmp_path)", tmp)
        return True
    except Exception as e:  # noqa: BLE001
        _row(_BAD, "scratch dir", f"not writable: {e}")
        return False


def _device(timeout_s: float) -> bool:
    import torch

    def probe():
        if not torch.cuda.is_available():
            return None
        props = torch.cuda.get_device_properties(0)
        return torch.cuda.device_count(), props.name, (props.major, props.minor), props.total_memory

    t0 = time.time()
    out, err = _watchdog(probe, timeout_s)
    if err is not None:
        _row(_BAD, "cuda device", f"probe failed: {err}")
        return False
    if out is None:
        if torch.cuda.is_available() is False:
            _row(_BAD, "cuda device", "no CUDA device — pass --device=cpu to check the CPU path only")
        else:
            _row(_BAD, "cuda device", f"probe still hung after {timeout_s:.0f}s")
        return False
    count, name, cap, mem = out
    _row(_OK, "cuda device", f"{name}, sm_{cap[0]}{cap[1]}, {mem / 2**30:.0f} GiB, "
                             f"{count} device(s) in {time.time() - t0:.1f}s")
    _row(_OPT, "device count", f"{count} — data-parallel and mesh_spatial modes available: python -m "
         f"torch.distributed.run --nproc_per_node={count} -m zsgnet_tpu_torch.main <uid> --multi_host=True "
         "[--mesh_spatial=S]; serve with --data_parallel=true or --mesh_spatial=S" if count > 1 else "1")
    if cap != (9, 0):
        _row(_OPT, "nvcc arch", f"the kernels target sm_90a (Hopper); this card is sm_{cap[0]}{cap[1]}")
    return True


def _build(timeout_s: float) -> bool:
    from zsgnet_tpu_torch.ops.cuda import build

    try:
        nvcc = build._nvcc()
    except Exception as e:  # noqa: BLE001
        _row(_BAD, "kernels built", f"{e}")
        return False
    _row(_OPT, "nvcc arch", f"{nvcc}: {' '.join(build.NVCC_FLAGS[:2])}")
    t0 = time.time()
    out, err = _watchdog(lambda: build.load_all(KERNELS), timeout_s)
    if err is not None:
        _row(_BAD, "kernels built", f"{err}")
        return False
    if out is None:
        _row(_BAD, "kernels built", f"nvcc still running after {timeout_s:.0f}s")
        return False
    _row(_OK, "kernels built", f"{', '.join(f'csrc/{k}.cu' for k in KERNELS)} in {time.time() - t0:.1f}s "
                               f"into {build.BUILD_DIR}")
    return True


def _matmul_smoke(device: str) -> bool:
    import torch

    try:
        t0 = time.time()
        x = torch.ones((256, 256), dtype=torch.bfloat16, device=device)
        # Summed in float32: a bf16 accumulator stalls near 2^17.
        val, want = float((x @ x).float().sum()), float(256 ** 3)
        _row(_OK, "smoke (256² bf16 matmul)", f"= {val:.0f} on {device} in {time.time() - t0:.2f}s")
        return abs(val - want) <= 0.01 * want
    except Exception as e:  # noqa: BLE001
        _row(_BAD, "smoke (256² bf16 matmul)", f"{e}")
        return False


def _k1_smoke() -> bool:
    """One K1 launch at B = 4 on the 64² anchor pyramid against its plain
    version: num_pos exact, the two sums to rtol 1e-4."""
    import numpy as np
    import torch

    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for
    from zsgnet_tpu_torch.ops.cuda import fused_loss as fl
    from zsgnet_tpu_torch.tools.bench_loss import random_inputs

    try:
        anchors = anchor_pyramid_for(Config(resize_img=(64, 64)))
        dev = torch.device("cuda")
        att, bbx, gt, w = (torch.from_numpy(x).to(dev) for x in random_inputs(
            anchors, 4, np.random.default_rng(0)))
        anc = fl.pack_anchors(anchors, dev)
        before = fl.fused_match_loss.launches
        got = fl.fused_match_loss(att, bbx, *anc, gt, w).double().cpu()
        want = fl.fused_match_loss_reference(att, bbx, *anc, gt, w).double().cpu()
        launched = fl.fused_match_loss.launches - before
        ok = launched == 1 and got[2] == want[2] and torch.allclose(got[:2], want[:2], rtol=1e-4, atol=0.0)
        _row(_OK if ok else _BAD, "smoke (K1 fused loss)",
             f"B=4 A={anchors.shape[0]}: kernel {[round(v, 4) for v in got.tolist()]} plain "
             f"{[round(v, 4) for v in want.tolist()]}, {launched} launch")
        return bool(ok)
    except Exception as e:  # noqa: BLE001
        _row(_BAD, "smoke (K1 fused loss)", f"{e}")
        return False


def _native() -> None:
    try:
        from zsgnet_tpu_torch.data import native

        _row(_OPT, "native image pipeline", native.status())
    except Exception as e:  # noqa: BLE001
        _row(_OPT, "native image pipeline", f"probe failed: {e}")


def _tensorboard() -> None:
    try:
        import tensorboardX

        _row(_OPT, "tensorboardX", f"{tensorboardX.__version__} — cfg.use_tensorboard writes rows")
    except Exception:  # noqa: BLE001
        try:
            from torch.utils import tensorboard  # noqa: F401

            _row(_OPT, "tensorboardX", "not installed — cfg.use_tensorboard writes rows through "
                                       "torch.utils.tensorboard")
        except Exception:  # noqa: BLE001
            _row(_OPT, "tensorboardX", "not installed — cfg.use_tensorboard writes the JSONL log only")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    overrides = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    timeout_s = float(overrides.get("timeout", "60"))
    device = overrides.get("device", "cuda")
    smoke = overrides.get("smoke", "true").lower() in ("1", "true", "yes")

    print("zsgnet_tpu_torch doctor — environment self-check", flush=True)
    good = _versions()
    good &= _config()
    good &= _scratch()
    if device == "cpu":
        _row(_OPT, "cuda device", "skipped (--device=cpu): the plain PyTorch versions run")
        if smoke:
            good &= _matmul_smoke("cpu")
    else:
        has_device = _device(timeout_s)
        good &= has_device
        if has_device:
            # nvcc takes minutes for a cold build: its own, longer deadline.
            built = _build(max(timeout_s, 600.0))
            good &= built
            if smoke:
                good &= _matmul_smoke("cuda")
                good &= built and _k1_smoke()
    _native()
    _tensorboard()
    print("all required checks passed" if good else "REQUIRED CHECKS FAILED — see rows above", flush=True)
    return 0 if good else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # noqa: BLE001 — the doctor itself must not stack-trace
        _row(_BAD, "doctor", f"stopped: {e!r}")
        sys.exit(1)
