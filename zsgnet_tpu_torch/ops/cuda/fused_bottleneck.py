"""Fused inference ResNet bottleneck, stride 1 — kernel K3 and its plain
version.

Port of ``zsgnet_tpu/ops/pallas/fused_bottleneck.py``, with its public
layout and argument convention: x (B, H, W, Cin) NHWC in bf16 or float32;
w1 (Cin, Cmid), w2 (3, 3, Cmid, Cmid) HWIO, w3 (Cmid, Cout), the optional
projection wd (Cin, Cout); per-channel scale and bias vectors from
:func:`fold_bn`. It computes

    y = relu(s3·conv1x1(relu(s2·conv3x3(relu(s1·conv1x1(x) + b1)) + b2)) + b3 + r)

with r = x (identity, Cin == Cout) or sd·conv1x1(x, wd) + bd, in bf16
operands with float32 accumulation; the output has x's dtype.

* on CUDA tensors ``fused_bottleneck_infer`` launches kernel K3, written by
  hand in ``csrc/fused_bottleneck.cu`` (built at first use,
  ``ops/cuda/build.py``), or raises — it never falls back;
* on CPU tensors it runs ``bottleneck_infer_reference``, the same function
  in eager PyTorch.

``fused_bottleneck_infer.launches`` counts kernel launches. No model path
of the port calls K3, as none of the JAX package does: it is driven by
``zsgnet_tpu_torch.tools.bench_bottleneck``, ``chip_smoke.py`` and the tests,
which fold the port's own ``models.resnet.Bottleneck`` with
:func:`block_args`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

_DTYPES = (torch.bfloat16, torch.float32)


def fold_bn(scale: Tensor, bias: Tensor, mean: Tensor, var: Tensor, eps: float = 1e-5):
    """BatchNorm (inference) → per-channel (s, b) with y = s·x + b."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def block_args(block: nn.Module) -> dict[str, Tensor]:
    """The kernel's arguments for one of the port's ``models.resnet.Bottleneck``
    modules: 1×1 weights (O, I, 1, 1) → (I, O), the 3×3 OIHW → HWIO, each
    BatchNorm's running statistics folded by :func:`fold_bn`; float32,
    contiguous, on the block's device. Stride 1 only."""
    if tuple(block.conv2.stride) != (1, 1):
        raise ValueError(f"the fused bottleneck is stride 1 only, got stride {block.conv2.stride}")

    def fold(bn: nn.BatchNorm2d) -> tuple[Tensor, Tensor]:
        return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)

    def one_by_one(conv: nn.Conv2d) -> Tensor:
        return conv.weight[:, :, 0, 0].t()

    with torch.no_grad():
        (s1, b1), (s2, b2), (s3, b3) = fold(block.bn1), fold(block.bn2), fold(block.bn3)
        args = dict(w1=one_by_one(block.conv1), s1=s1, b1=b1,
                    w2=block.conv2.weight.permute(2, 3, 1, 0), s2=s2, b2=b2,
                    w3=one_by_one(block.conv3), s3=s3, b3=b3)
        if block.downsample is not None:
            sd, bd = fold(block.downsample[1])
            args.update(wd=one_by_one(block.downsample[0]), sd=sd, bd=bd)
        return {k: v.detach().float().contiguous() for k, v in args.items()}


def _to_bf16(t: Tensor) -> Tensor:
    return t.to(torch.bfloat16).float()


def _bottleneck_math(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd, rnd) -> Tensor:
    """The block in float32 on NHWC tensors, with ``rnd`` applied to every
    conv operand and to h1 and h2; returns float32 before the final cast."""
    f32 = torch.float32
    xr = rnd(x.float())
    vec = lambda v: v.float().reshape(-1)  # noqa: E731
    h = rnd(torch.relu(xr @ rnd(w1.float()) * vec(s1) + vec(b1)))
    _, hh, ww, _ = h.shape
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    w2r = rnd(w2.float())
    acc = torch.zeros(h.shape[:3] + (w2.shape[3],), dtype=f32, device=h.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + hp[:, dy:dy + hh, dx:dx + ww, :] @ w2r[dy, dx]
    h = rnd(torch.relu(acc * vec(s2) + vec(b2)))
    y = h @ rnd(w3.float()) * vec(s3) + vec(b3)
    if wd is not None:
        y = y + (xr @ rnd(wd.float()) * vec(sd) + vec(bd))
    else:
        y = y + x.float()
    return torch.relu(y)


def bottleneck_infer_reference(
    x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor, b2: Tensor,
    w3: Tensor, s3: Tensor, b3: Tensor, wd: Tensor | None = None, sd: Tensor | None = None,
    bd: Tensor | None = None,
) -> Tensor:
    """Plain PyTorch version of K3, with the rounding points of the JAX
    ``bottleneck_infer_reference``: bf16 conv operands with float32
    accumulation (computed as float32 products of bf16-rounded values, which
    is the same function and needs no bf16 matmul), h1 and h2 rounded to
    bf16, the identity residual added in float32 from x in its own dtype,
    the output cast to x's dtype. Float32 matmuls: on CUDA this assumes
    ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default."""
    return _bottleneck_math(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd, _to_bf16).to(x.dtype)


def _lib() -> ctypes.CDLL:
    from zsgnet_tpu_torch.ops.cuda import build

    lib = build.load("fused_bottleneck")
    if not getattr(lib, "_zsg_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.zsg_bottleneck_infer.argtypes = [ptr] * 14 + [i32] * 7 + [ptr]
        lib.zsg_bottleneck_infer.restype = i32
        lib.zsg_bottleneck_smem_bytes.argtypes = [i32] * 4
        lib.zsg_bottleneck_smem_bytes.restype = ctypes.c_longlong
        lib.zsg_bottleneck_max_smem.argtypes = []
        lib.zsg_bottleneck_max_smem.restype = i32
        lib._zsg_typed = True
    return lib


def _check_args(x: Tensor, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd) -> tuple[int, int, int]:
    """Check what both versions take; → (Cin, Cmid, Cout)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected bfloat16 or float32")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    cin = x.shape[3]
    if w1.dim() != 2 or w1.shape[0] != cin:
        raise ValueError(f"w1 has shape {tuple(w1.shape)}, expected ({cin}, Cmid)")
    cmid = w1.shape[1]
    if w3.dim() != 2 or w3.shape[0] != cmid:
        raise ValueError(f"w3 has shape {tuple(w3.shape)}, expected ({cmid}, Cout)")
    cout = w3.shape[1]
    shapes = {"w1": (w1, (cin, cmid)), "w3": (w3, (cmid, cout)),
              "w2": (w2, (3, 3, cmid, cmid)), "s1": (s1, (cmid,)), "b1": (b1, (cmid,)),
              "s2": (s2, (cmid,)), "b2": (b2, (cmid,)), "s3": (s3, (cout,)), "b3": (b3, (cout,))}
    proj = [v is not None for v in (wd, sd, bd)]
    if any(proj) and not all(proj):
        raise ValueError("the projection residual needs all of wd, sd and bd")
    if all(proj):
        shapes.update(wd=(wd, (cin, cout)), sd=(sd, (cout,)), bd=(bd, (cout,)))
    elif cin != cout:
        raise ValueError(f"identity residual needs Cin == Cout, got {cin} and {cout}")
    for name, (t, shape) in shapes.items():
        got = tuple(t.shape) if name.startswith("w") else (t.numel(),)
        if got != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return cin, cmid, cout


def _launch(x: Tensor, cin: int, cmid: int, cout: int, *ws: Tensor | None) -> Tensor:
    """Launch K3 on the current stream → (B, H, W, Cout) in x's dtype."""
    if cin % 16 or cout % 16 or not 0 < cmid <= 64:
        raise ValueError(f"the kernel takes Cin and Cout multiples of 16 and Cmid up to 64, "
                         f"got {cin}, {cout} and {cmid}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the kernel's 16-byte copies")
    lib = _lib()
    dev = x.device
    proj = ws[-1] is not None
    ws = [None if w is None else w.float().contiguous() for w in ws]
    with torch.cuda.device(dev):  # the runtime launches on the current device
        need, limit = lib.zsg_bottleneck_smem_bytes(cin, cmid, cout, int(proj)), lib.zsg_bottleneck_max_smem()
        if need > limit:
            raise ValueError(f"widths Cin {cin}, Cmid {cmid}, Cout {cout} need {need} bytes of shared "
                             f"memory per block; the device allows {limit}")
        b, h, w, _ = x.shape
        out = torch.empty((b, h, w, cout), dtype=x.dtype, device=dev)
        err = lib.zsg_bottleneck_infer(
            x.data_ptr(), *(None if t is None else t.data_ptr() for t in ws), out.data_ptr(),
            b, h, w, cin, cmid, cout, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused bottleneck kernel launch failed with CUDA error {err}")
    return out


def fused_bottleneck_infer(
    x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor, b2: Tensor,
    w3: Tensor, s3: Tensor, b3: Tensor, wd: Tensor | None = None, sd: Tensor | None = None,
    bd: Tensor | None = None,
) -> Tensor:
    """One inference bottleneck block, fused; stride 1 only.

    x (B, H, W, Cin) bf16 or float32, contiguous; w1 (Cin, Cmid); w2 (3, 3,
    Cmid, Cmid); w3 (Cmid, Cout); s*/b* folded BatchNorm (:func:`fold_bn`);
    wd/sd/bd the 1×1 projection residual, required when Cin != Cout. K3 on
    CUDA (Cin and Cout multiples of 16, Cmid up to 64), the plain version on
    the CPU. Returns (B, H, W, Cout) in x's dtype.
    """
    cin, cmid, cout = _check_args(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd)
    if x.device.type == "cpu":
        return bottleneck_infer_reference(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"the fused bottleneck runs on cuda or cpu, not {x.device}")
    out = _launch(x, cin, cmid, cout, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd)
    fused_bottleneck_infer.launches += 1
    return out


fused_bottleneck_infer.launches = 0
