"""Post-training int8 quantization for serving — torch port of
``zsgnet_tpu/models/quant.py``.

* :class:`QuantConv2d` is a drop-in for ``nn.Conv2d`` with the same
  parameters (``weight``, ``bias``), so checkpoints serve in either mode.
  Its ``mode`` is ``"off"`` (``nn.Conv2d``), ``"calib"`` (the float conv,
  recording the input's ``max |x|`` or, under ``"calib@p"``, its p-quantile,
  as a running maximum) or ``"int8"``.
* Activation scales are kept **per input spatial shape**, as buffers
  ``act_absmax_{H}x{W}``: the shared head runs on every pyramid level and
  so calibrates one scale per level (one scale for all collapses accuracy,
  ``BASELINE.md``). The head's conv0 keeps ``vis_absmax_{H}x{W}`` for its
  visual channels (``models/zsgnet.py``).
* Weights quantize per output channel (``max |w|`` over ``I, kh, kw`` of
  torch's ``(O, I, kh, kw)``), activations per tensor, both symmetric:
  ``round(x / s)`` (half to even, as ``jnp.round``) clipped to ±127.
* The product accumulates in int32 and is exact, so equal quantized inputs
  give the JAX package's int32 sums bit for bit. The dequantization
  multiplies by ``act_scale · w_scale`` and adds the bias in float32.

The integer product is an int8 im2col (built by slicing, in int8) times the
quantized weight. On the card it is ``torch._int_mm``, cuBLASLt's
int8 × int8 → int32 GEMM on Hopper's integer tensor cores, which wants
M > 16 and K and N multiples of 8: :func:`int8_matmul` pads with zeros
where a shape falls short (the stem's K = 7·7·3 = 147 → 152, the head's
``out`` N = 45 → 48, a batch-1 request's 3×3 and 1×1 levels M = 9, 1 →
32) and crops the result. On the CPU it is the plain, exact float64 matmul
over the same operands. The JAX package's int8 conv is XLA's, not a Pallas kernel,
so the port takes the library GEMM here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

QMAX = 127.0


def parse_quant_mode(mode: str) -> tuple[str, float]:
    """``"calib@0.999"`` → ``("calib", 0.999)``; plain modes → ``(mode, 1.0)``."""
    if "@" in mode:
        base, pct = mode.split("@", 1)
        return base, float(pct)
    return mode, 1.0


def quantize_sym(x: Tensor, scale: Tensor) -> Tensor:
    """Symmetric int8: ``round(x / scale)`` clipped to ±127."""
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8)


def absmax_stat(x: Tensor, percentile: float) -> Tensor:
    """``max |x|``, or for ``percentile`` < 1 the ``jnp.quantile`` of |x| at
    it with the same linear interpolation and float32 position arithmetic,
    its second product fused into the sum as XLA's CPU code does. A full
    sort: ``torch.quantile`` refuses more than 2^24 elements (layer1 at
    B = 32 has 46 M)."""
    a = x.detach().float().abs().flatten()
    if percentile >= 1.0:
        return a.max()
    n = a.numel()
    pos = np.float32(percentile) * (np.float32(n) - np.float32(1.0))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    s = torch.sort(a).values
    return ((s[lo] * float(w_lo)).double() + s[hi].double() * float(w_hi)).float()


def weight_scale(weight: Tensor) -> Tensor:
    """Per-output-channel scale (O,) of an (O, I, kh, kw) weight."""
    return torch.clamp(weight.detach().float().abs().amax(dim=(1, 2, 3)), min=1e-12) / QMAX


def act_scale(absmax: Tensor) -> Tensor:
    """An uncalibrated (zero) absmax gives every activation ±127: garbage,
    but finite, as in the JAX package."""
    return torch.clamp(absmax, min=1e-6) / QMAX


def int8_matmul_reference(a: Tensor, b: Tensor) -> Tensor:
    """(M, K) int8 × (K, N) int8 → (M, N) int32 on any device, as a float64
    product: every partial sum is an integer of magnitude ≤ K·127² < 2^53,
    so it is exact (and several times faster than int64 on the CPU)."""
    return (a.double() @ b.double()).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_for_int_mm(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Zero-pad (M, K) and (K, N) to what ``torch._int_mm`` takes on the
    card: M ≥ 32 and a multiple of 8, K and N multiples of 8. The padding
    adds zero terms and rows/columns that the caller crops."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(_round_up(m, 8), 32) - m, _round_up(k, 8) - k, _round_up(n, 8) - n
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return a, b


def int8_matmul(a: Tensor, b: Tensor) -> Tensor:
    """(M, K) int8 × (K, N) int8 → (M, N) int32: ``torch._int_mm`` on a
    CUDA tensor (operands padded by :func:`pad_for_int_mm`, ``b``
    column-major), the plain product on a CPU one."""
    if not a.is_cuda:
        return int8_matmul_reference(a, b)
    m, n = a.shape[0], b.shape[1]
    ap, bp = pad_for_int_mm(a.contiguous(), b)
    out = torch._int_mm(ap, bp.t().contiguous().t())
    return out[:m, :n]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def im2col_int8(x: Tensor, kernel: tuple[int, int], stride, padding, dilation) -> tuple[Tensor, int, int]:
    """(N, C, H, W) int8 → ((N·Ho·Wo, C·kh·kw) int8, Ho, Wo), columns in the
    order of ``weight.reshape(O, -1)``: channel-major, then kh, kw. Built
    by slicing the zero-padded NHWC input once per tap."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = _pair(kernel), _pair(stride), _pair(padding), _pair(dilation)
    n, c, h, w = x.shape
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, pw, pw, ph, ph))
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    taps = [
        xp[:, i * dh : i * dh + sh * (ho - 1) + 1 : sh, j * dw : j * dw + sw * (wo - 1) + 1 : sw, :]
        for i in range(kh) for j in range(kw)
    ]
    cols = taps[0][..., None] if len(taps) == 1 else torch.stack(taps, dim=-1)
    return cols.reshape(n * ho * wo, c * kh * kw), ho, wo


def int8_conv2d(xq: Tensor, wq: Tensor, stride=1, padding=0, dilation=1) -> Tensor:
    """The exact int32 convolution of int8 ``xq`` (N, C, H, W) by int8 ``wq``
    (O, C, kh, kw) → (N, O, Ho, Wo) int32, channels-last in memory."""
    cols, ho, wo = im2col_int8(xq, wq.shape[2:], stride, padding, dilation)
    y = int8_matmul(cols, wq.reshape(wq.shape[0], -1).t())
    return y.reshape(xq.shape[0], ho, wo, wq.shape[0]).permute(0, 3, 1, 2)


def quantized_conv(x: Tensor, absmax: Tensor, weight: Tensor, bias: Tensor | None, stride=1, padding=0,
                   dilation=1) -> Tensor:
    """The int8 serving conv: per-tensor activation and per-channel weight
    quantization, the exact int32 product, then ``y · act_scale · w_scale +
    bias`` in float32."""
    s_act = act_scale(absmax)
    s_w = weight_scale(weight)
    y32 = int8_conv2d(quantize_sym(x.float(), s_act), quantize_sym(weight.float(), s_w[:, None, None, None]),
                      stride, padding, dilation)
    y = y32.float() * (s_act * s_w)[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y


class ScaleBuffers:
    """Activation scales as buffers named by the input's spatial shape,
    created at calibration; a ``state_dict`` that carries them (a calibrated
    model's, or the JAX ``quant`` collection through ``convert``) loads into
    a fresh module."""

    def absmax(self, prefix: str, x: Tensor, rows: int | None = None) -> Tensor:
        """The scale of ``x``'s spatial shape, or of ``rows`` × its width for
        a height shard of a ``rows``-high input."""
        name = f"{prefix}_absmax_{rows or x.shape[-2]}x{x.shape[-1]}"
        buf = getattr(self, name, None)
        if buf is None:
            buf = torch.zeros((), dtype=torch.float32, device=x.device)
            self.register_buffer(name, buf)
        return buf

    def record(self, prefix: str, x: Tensor, percentile: float) -> None:
        buf = self.absmax(prefix, x)
        buf.copy_(torch.maximum(buf, absmax_stat(x, percentile)))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for key, value in state_dict.items():
            name = key[len(prefix):]
            if key.startswith(prefix) and "." not in name and "_absmax_" in name and getattr(self, name, None) is None:
                self.register_buffer(name, torch.zeros_like(value))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class QuantConv2d(ScaleBuffers, nn.Conv2d):
    """``nn.Conv2d`` with int8 inference (``mode`` "off", "calib" or
    "int8"; ``percentile`` clips the calibration statistic). ``padding=``
    overrides the module's padding for one call; ``rows=`` (a height shard's
    global input height, ``parallel.halo.conv_rows``) keys the activation
    scale in place of ``x``'s height."""

    def __init__(self, *args, mode: str = "off", percentile: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.mode, self.percentile = mode, percentile

    def forward(self, x: Tensor, padding: int | None = None, rows: int | None = None) -> Tensor:
        pad = self.padding if padding is None else padding
        if self.mode == "int8":
            y = quantized_conv(x, self.absmax("act", x, rows), self.weight, self.bias, self.stride, pad, self.dilation)
            return y.to(torch.get_autocast_dtype("cuda")) if x.is_cuda and torch.is_autocast_enabled("cuda") else y
        if self.mode == "calib":
            if rows is not None:
                raise ValueError("a height shard has no whole-input statistic: calibrate the unsharded model")
            with torch.no_grad():
                self.record("act", x, self.percentile)
        elif self.mode != "off":
            raise ValueError(f"unknown quant mode {self.mode!r}")
        return F.conv2d(x, self.weight, self.bias, self.stride, pad, self.dilation)


def conv_for(mode: str, *args, **kw) -> nn.Conv2d:
    """A plain ``nn.Conv2d`` when ``mode`` is "off", else a
    :class:`QuantConv2d` in that mode (same parameters either way)."""
    base, pct = parse_quant_mode(mode)
    if base == "off":
        return nn.Conv2d(*args, **kw)
    if base not in ("calib", "int8"):
        raise ValueError(f"unknown quant mode {mode!r}")
    return QuantConv2d(*args, mode=base, percentile=pct, **kw)


def set_quant_mode(model: nn.Module, mode: str) -> None:
    """Switch every quantizable module of ``model`` to ``mode`` ("calib",
    "calib@p" or "int8")."""
    base, pct = parse_quant_mode(mode)
    for m in model.modules():
        if isinstance(m, ScaleBuffers):
            m.mode, m.percentile = base, pct


def quant_scales(model: nn.Module) -> dict[str, Tensor]:
    """Every recorded activation scale of ``model``, by state_dict name."""
    return {k: v for k, v in model.state_dict().items() if "_absmax_" in k}
