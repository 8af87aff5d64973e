"""Where K3's Hopper kernel spends a tile: cycles per stage, on the card.

    python -m zsgnet_tpu_torch.tools.k3_stage_clocks [B]

Builds ``csrc/fused_bottleneck.cu`` once more with ``-DZSG_K3_CLOCKS``, which
compiles ``clock64`` marks into the consumer loop (the library that the
package uses has none), runs the ResNet-50 layer1 identity and projection
blocks at [B, 75, 75, ·] (default 16) through both tile shapes, and prints
for each the mean cycles per tile that block 0's first consumer thread
spent between the marks, after the card's name, power limit and highest SM clock. The marks stop the compiler from
moving work across stage boundaries, so the total runs a few per cent over
the kernel's own time: read the shares, not the sum.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from zsgnet_tpu_torch.ops.cuda import build, fused_bottleneck as fb
from zsgnet_tpu_torch.tools.bench_bottleneck import CMID, COUT, H, W, random_args

STAGES = ("stage 1, second half", "h1 epilogue and barriers", "stage 2", "stage 3, first chunks",
          "next tile's stage 1, first half", "stage 3, rest")
WEIGHTS = ("w1", "s1", "b1", "w2", "s2", "b2", "w3", "s3", "b3", "wd", "sd", "bd")


def stage_clocks(b: int, proj: bool, variant: str, seed: int = 0) -> dict[str, float]:
    """Mean cycles per tile and stage of one launch of ``variant`` (after two
    warm launches) on a seeded bf16 layer1 block at batch ``b``."""
    lib = fb._typed(build.load("fused_bottleneck", ("-DZSG_K3_CLOCKS",)))
    lib.zsg_bottleneck_read_clocks.argtypes = [ctypes.c_void_p]
    lib.zsg_bottleneck_read_clocks.restype = ctypes.c_int
    cin = CMID if proj else COUT
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, H, W, cin)).astype(np.float32)).cuda().bfloat16()
    args = random_args(rng, cin, CMID, COUT, proj, "cuda")
    ptrs = [args[k].data_ptr() if k in args else None for k in WEIGHTS]
    packed = torch.empty((lib.zsg_bottleneck_packed_bytes(cin, COUT, int(proj)),), dtype=torch.uint8,
                         device="cuda")
    out = torch.empty((b, H, W, COUT), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.zsg_bottleneck_pack(*ptrs, packed.data_ptr(), cin, CMID, COUT, stream)
    for _ in range(3):
        err = err or lib.zsg_bottleneck_infer_variant(
            x.data_ptr(), *ptrs, packed.data_ptr(), out.data_ptr(), b, H, W, cin, CMID, COUT, 1,
            fb.VARIANTS[variant], 0, stream)
    torch.cuda.synchronize()
    host = (ctypes.c_longlong * 7)()
    err = err or lib.zsg_bottleneck_read_clocks(host)
    if err != 0:
        raise RuntimeError(f"K3 stage clocks: CUDA error {err}")
    want = fb.bottleneck_infer_reference(x, **args)
    if not torch.allclose(out.float(), want.float(), atol=2e-2, rtol=2e-2):
        raise AssertionError("the instrumented kernel disagrees with the plain version")
    tiles = max(host[6], 1)
    return {name: host[i] / tiles for i, name in enumerate(STAGES)}


def main(argv: list[str]) -> int:
    b = int(argv[0]) if argv else 16
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for proj in (False, True):
        for variant in ("wgmma8x16", "wgmma8x8"):
            clocks = stage_clocks(b, proj, variant)
            print(f"{'projection' if proj else 'identity'} B={b} {variant}: cycles per tile "
                  f"{sum(clocks.values()):.0f}: " + ", ".join(f"{k} {v:.0f}" for k, v in clocks.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
