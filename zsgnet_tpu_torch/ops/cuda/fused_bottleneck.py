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
  ``ops/cuda/build.py``), or raises — it never falls back. The source holds
  two kernels and picks one from the shape alone before it launches: the
  Hopper kernel (``wgmma`` in every stage, x brought in by TMA) takes Cmid 64
  with Cin and Cout multiples of 64, which are ResNet-50's layer1 widths;
  the ``mma.sync`` kernel takes every other shape (:func:`kernel_for`);
* on CPU tensors it runs ``bottleneck_infer_reference``, the same function
  in eager PyTorch.

``fused_bottleneck_infer.launches`` counts kernel launches of
``fused_bottleneck_infer`` (one per call); the Hopper kernel's weights are
packed by one more launch the first time a set of weights is seen, counted
apart in ``fused_bottleneck_infer.pack_launches``; :func:`launch_variant` (a named kernel at any
shape it takes, for timing the two side by side) counts none. No model path
of the port calls K3, as none of the JAX package does: it is driven by
``zsgnet_tpu_torch.tools.bench_bottleneck``, ``chip_smoke.py`` and the tests,
which fold the port's own ``models.resnet.Bottleneck`` with
:func:`block_args`.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

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


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of the library's C interface (once)."""
    if not getattr(lib, "_zsg_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.zsg_bottleneck_infer_variant.argtypes = [ptr] * 15 + [i32] * 9 + [ptr]
        lib.zsg_bottleneck_infer_variant.restype = i32
        lib.zsg_bottleneck_pack.argtypes = [ptr] * 13 + [i32] * 3 + [ptr]
        lib.zsg_bottleneck_pack.restype = i32
        lib.zsg_bottleneck_packed_bytes.argtypes = [i32] * 3
        lib.zsg_bottleneck_packed_bytes.restype = ctypes.c_longlong
        lib.zsg_bottleneck_variant.argtypes = [i32] * 4
        lib.zsg_bottleneck_variant.restype = i32
        lib.zsg_bottleneck_smem_bytes.argtypes = [i32] * 4
        lib.zsg_bottleneck_smem_bytes.restype = ctypes.c_longlong
        lib.zsg_bottleneck_max_smem.argtypes = []
        lib.zsg_bottleneck_max_smem.restype = i32
        lib._zsg_typed = True
    return lib


def _lib() -> ctypes.CDLL:
    from zsgnet_tpu_torch.ops.cuda import build

    return _typed(build.load("fused_bottleneck"))


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


VARIANTS = {"auto": 0, "mma": 1, "wgmma8x8": 2, "wgmma8x16": 3}


def kernel_for(cin: int, cmid: int, cout: int, proj: bool) -> str:
    """The kernel that K3 launches for these widths: ``"mma"`` or
    ``"wgmma8x16"`` (the Hopper kernel with its 8 × 16 output tile; its 8 × 8
    instance, ``"wgmma8x8"``, runs only through :func:`launch_variant`).
    Decided in the CUDA source from the widths alone."""
    code = _lib().zsg_bottleneck_variant(cin, cmid, cout, int(proj))
    return next(k for k, v in VARIANTS.items() if v == code)


def _check_kernel_layout(x: Tensor, cin: int, cmid: int, cout: int) -> None:
    """What the kernels need beyond :func:`_check_args`: widths, and an x that
    16-byte copies and the TMA tensor map can address (a 16-byte aligned base
    and a pixel stride that is a multiple of 16 bytes)."""
    if cin % 16 or cout % 16 or not 0 < cmid <= 64:
        raise ValueError(f"the kernel takes Cin and Cout multiples of 16 and Cmid up to 64, "
                         f"got {cin}, {cout} and {cmid}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the kernel's 16-byte copies and its tensor map")
    if x.stride(3) != 1 or (x.stride(2) * x.element_size()) % 16:
        raise ValueError(f"x's channels must be contiguous and its pixel stride a multiple of 16 bytes, "
                         f"got strides {tuple(x.stride())}")


# The Hopper kernel reads a block's weights packed (bf16, transposed and
# swizzled as it keeps them in shared memory, scales and biases behind
# them). They are made by one launch of a packing kernel the first time a
# set of weights is seen on a stream, and kept here. The key holds each
# tensor's identity and version counter (an in-place update packs anew;
# inference tensors have no counter and must not be updated in place between
# calls), and the entry keeps the tensors alive, so an identity in a key is
# never another tensor's.
_PACKED_MAX = 64
_packed: OrderedDict[tuple, tuple[Tensor, tuple]] = OrderedDict()
_plans: dict[tuple, str] = {}  # (device, widths) → the kernel K3 launches, its shared memory checked


def _packed_weights(lib: ctypes.CDLL, ws: tuple[Tensor | None, ...], cin: int, cmid: int, cout: int,
                    stream: int) -> Tensor:
    key = (stream, *(None if w is None else (id(w), 0 if w.is_inference() else w._version) for w in ws))
    hit = _packed.get(key)
    if hit is not None:
        _packed.move_to_end(key)
        return hit[0]
    f32 = [None if w is None else w.float().contiguous() for w in ws]
    packed = torch.empty((lib.zsg_bottleneck_packed_bytes(cin, cout, int(ws[-1] is not None)),),
                         dtype=torch.uint8, device=ws[0].device)
    err = lib.zsg_bottleneck_pack(*(None if t is None else t.data_ptr() for t in f32), packed.data_ptr(),
                                  cin, cmid, cout, stream)  # on this stream: ordered before its readers
    if err != 0:
        raise RuntimeError(f"fused bottleneck packing kernel launch failed with CUDA error {err}")
    fused_bottleneck_infer.pack_launches += 1
    _packed[key] = (packed, ws)
    if len(_packed) > _PACKED_MAX:
        _packed.popitem(last=False)
    return packed


def _plan(lib: ctypes.CDLL, dev: torch.device, cin: int, cmid: int, cout: int, proj: bool) -> str:
    """The kernel for these widths on ``dev`` (with the device current), after
    checking once that its shared memory fits the card."""
    key = (dev, cin, cmid, cout, proj)
    if key not in _plans:
        need, limit = lib.zsg_bottleneck_smem_bytes(cin, cmid, cout, int(proj)), lib.zsg_bottleneck_max_smem()
        if need > limit:
            raise ValueError(f"widths Cin {cin}, Cmid {cmid}, Cout {cout} need {need} bytes of shared "
                             f"memory per block; the device allows {limit}")
        _plans[key] = kernel_for(cin, cmid, cout, proj)
    return _plans[key]


def _launch(x: Tensor, cin: int, cmid: int, cout: int, *ws: Tensor | None,
            variant: str = "auto", prologue_only: bool = False) -> Tensor:
    """Launch K3 on the current stream → (B, H, W, Cout) in x's dtype."""
    _check_kernel_layout(x, cin, cmid, cout)
    lib = _lib()
    dev = x.device
    with torch.cuda.device(dev):  # the runtime launches on the current device
        kernel = _plan(lib, dev, cin, cmid, cout, ws[-1] is not None)
        if variant != "auto":
            kernel = variant
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "mma":  # reads the float32 weights themselves
            packed, ptrs = None, [None if w is None else w.float().contiguous() for w in ws]
        else:  # reads only the packed copy; a non-null wd still says "projection"
            packed, ptrs = _packed_weights(lib, ws, cin, cmid, cout, stream), ws
        b, h, w, _ = x.shape
        out = torch.empty((b, h, w, cout), dtype=x.dtype, device=dev)
        err = lib.zsg_bottleneck_infer_variant(
            x.data_ptr(), *(None if t is None else t.data_ptr() for t in ptrs),
            None if packed is None else packed.data_ptr(), out.data_ptr(),
            b, h, w, cin, cmid, cout, int(x.dtype == torch.bfloat16), VARIANTS[variant],
            int(prologue_only), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused bottleneck kernel ({variant}) launch failed with CUDA error {err}")
    return out


def launch_variant(
    variant: str, x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor, b2: Tensor,
    w3: Tensor, s3: Tensor, b3: Tensor, wd: Tensor | None = None, sd: Tensor | None = None,
    bd: Tensor | None = None, *, prologue_only: bool = False,
) -> Tensor:
    """K3 through the kernel named by ``variant`` (a key of ``VARIANTS``) on a
    CUDA tensor, whatever :func:`kernel_for` would pick; raises if that
    kernel does not take the shape. For timing the kernels side by side in
    one run; the package itself calls :func:`fused_bottleneck_infer`. With
    ``prologue_only`` the Hopper kernel's grid runs over no tile (its weight
    prologue alone) and the returned tensor is not written."""
    cin, cmid, cout = _check_args(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"launch_variant runs a kernel and needs a CUDA tensor, not {x.device}")
    return _launch(x, cin, cmid, cout, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd,
                   variant=variant, prologue_only=prologue_only)


def fused_bottleneck_infer(
    x: Tensor, w1: Tensor, s1: Tensor, b1: Tensor, w2: Tensor, s2: Tensor, b2: Tensor,
    w3: Tensor, s3: Tensor, b3: Tensor, wd: Tensor | None = None, sd: Tensor | None = None,
    bd: Tensor | None = None,
) -> Tensor:
    """One inference bottleneck block, fused; stride 1 only.

    x (B, H, W, Cin) bf16 or float32, contiguous; w1 (Cin, Cmid); w2 (3, 3,
    Cmid, Cmid); w3 (Cmid, Cout); s*/b* folded BatchNorm (:func:`fold_bn`);
    wd/sd/bd the 1×1 projection residual, required when Cin != Cout. K3 on
    CUDA (Cin and Cout multiples of 16, Cmid up to 64, x 16-byte aligned),
    the plain version on the CPU. Returns (B, H, W, Cout) in x's dtype.
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
fused_bottleneck_infer.pack_launches = 0  # launches of the weight-packing kernel, counted apart
