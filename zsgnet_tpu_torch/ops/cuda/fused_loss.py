"""Fused anchor match + focal + smooth-L1 loss — kernels K1 and K2 and
their plain versions.

Port of ``zsgnet_tpu/ops/pallas/fused_loss.py``. ``fused_match_loss``
returns the three sums (cls_sum, box_sum, num_pos) that ``zsg_loss_fused``
normalizes, with a gradient for the logits and the box deltas through
``FusedMatchLoss``, the counterpart of the JAX ``custom_vjp``:

* on CUDA tensors the forward launches kernel K1 and the backward kernel
  K2, both hand-written in ``csrc/fused_loss.cu`` (built at first use,
  ``ops/cuda/build.py``), or raises — they never fall back;
* on CPU tensors the forward runs ``fused_match_loss_reference`` and the
  backward ``fused_match_loss_backward_reference``, the same functions in
  eager PyTorch.

K1 also returns each row's first-index argmax-IoU anchor, which the JAX
package computes with XLA outside its Pallas kernel and saves as its VJP
residual; the Function saves it so that K2 searches nothing. The plain
versions recompute it with ``argmax``. K1 is one launch of one thread-block
cluster per row; its cross-row sum is taken by the last cluster to finish,
found with an integer ticket that this module keeps per device and stream.
K2 is one launch, a thread per (row, anchor); :func:`launch_bwd_variant`
runs any of its kernels by name (``BWD_VARIANTS``) for timing them side by
side. ``fused_match_loss.launches`` and ``fused_match_loss_backward.launches``
count kernel launches (the named launches count none).

Non-finite logits and deltas give what the JAX kernel gives as XLA compiles
it, where a product with a 0/1 label is a select: ``x·pos`` in the
cross-entropy is 0 at a non-positive anchor whatever ``x`` holds, the focal
term of an ignored anchor and both gradients where ``valid`` or ``pos`` is 0
are exact zeros, the box sum's ``loss·pos·w`` is NaN when a non-positive
anchor's delta is not finite, and ``sign(NaN)`` is NaN.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from zsgnet_tpu_torch.ops import boxes as box_ops
from zsgnet_tpu_torch.ops.losses import smooth_l1
from zsgnet_tpu_torch.parallel.mesh import all_reduce_sum

Tensor = torch.Tensor

BETA = 1.0 / 9.0  # smooth-L1 beta of the RetinaNet recipe, fixed as in the JAX kernel


def pack_anchors(anchors_cthw: np.ndarray | Tensor, device: str | torch.device) -> tuple[Tensor, Tensor]:
    """(A, 4) cthw anchors → contiguous float32 (tlbr, cthw) on ``device``,
    the two anchor inputs of :func:`fused_match_loss`."""
    cthw = torch.as_tensor(anchors_cthw, dtype=torch.float32).to(device).contiguous()
    return box_ops.cthw2tlbr(cthw).contiguous(), cthw


def _labels(anchors_tlbr: Tensor, gt: Tensor, match_thr: float, neg_thr: float) -> tuple[Tensor, Tensor]:
    """(pos, valid) bool (B, A) masks: positive at IoU ≥ match_thr or at the
    row's argmax-IoU anchor (the first of tied maxima), ignored in between."""
    iou = box_ops.iou_pairwise(gt[:, None, :], anchors_tlbr)[:, 0, :]
    best = iou.argmax(dim=-1, keepdim=True)
    is_best = torch.zeros_like(iou, dtype=torch.bool).scatter(-1, best, True)
    pos_b = (iou >= match_thr) | is_best
    return pos_b, pos_b | (iou < neg_thr)


def _focal_parts(x: Tensor, pos_b: Tensor, alpha: float) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(pos, p, p_t, alpha_t, bce) of the sigmoid focal loss as the JAX kernel
    computes them (``_focal_tile``), with ``x·pos`` a select."""
    pos = pos_b.float()
    p = torch.sigmoid(x)
    p_t = p * pos + (1.0 - p) * (1.0 - pos)
    alpha_t = alpha * pos + (1.0 - alpha) * (1.0 - pos)
    bce = x.clamp(min=0.0) - torch.where(pos_b, x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    return pos, p, p_t, alpha_t, bce


def fused_match_loss_reference(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor,
    gt: Tensor, w: Tensor, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0,
) -> Tensor:
    """Plain PyTorch version of K1: the same labels, losses and weights, as
    dense tensors. Returns (3,) float32 [cls_sum, box_sum, num_pos]."""
    pos_b, valid_b = _labels(anchors_tlbr, gt, match_thr, neg_thr)
    w = w.float()[:, None]
    pos, _, p_t, alpha_t, bce = _focal_parts(att.float(), pos_b, alpha)
    focal = alpha_t * torch.pow(1.0 - p_t, gamma) * bce
    cls_sum = (torch.where(valid_b, focal, 0.0) * w).sum()
    targets = box_ops.bbox_to_reg_params(anchors_cthw[None], gt[:, None, :])
    pos_w = pos * w
    box_sum = (smooth_l1(bbx, targets, BETA) * pos_w[..., None]).sum()
    return torch.stack([cls_sum, box_sum, pos_w.sum()])


def fused_match_loss_backward_reference(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor,
    gt: Tensor, w: Tensor, grad: Tensor, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0,
) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of K2, in the closed forms of the JAX kernel
    (``_focal_grad_tile``, ``_smooth_l1_and_grad``), not autograd.

    grad (3,) is the upstream gradient of (cls_sum, box_sum, num_pos);
    num_pos depends on no input that has a gradient. Returns datt (B, A)
    = g_cls·focal'(x)·valid·w and dbbx (B, A, 4) = g_box·smoothL1'(d)·pos·w,
    with ``valid`` and ``pos`` as selects.
    """
    pos_b, valid_b = _labels(anchors_tlbr, gt, match_thr, neg_thr)
    w = w.float()[:, None]
    pos, p, p_t, alpha_t, bce = _focal_parts(att.float(), pos_b, alpha)
    one_m = 1.0 - p_t
    dpt = (2.0 * pos - 1.0) * p * (1.0 - p)
    focal_grad = alpha_t * (
        -gamma * torch.pow(one_m, gamma - 1.0) * dpt * bce + torch.pow(one_m, gamma) * (p - pos)
    )
    datt = torch.where(valid_b, grad[0] * focal_grad, 0.0) * w
    d = bbx.float() - box_ops.bbox_to_reg_params(anchors_cthw[None], gt[:, None, :])
    sign = torch.where(d.isnan(), d, torch.sign(d))  # jnp.sign(NaN) is NaN, torch.sign(NaN) 0
    sl1_grad = torch.where(d.abs() < BETA, d / BETA, sign)
    dbbx = torch.where(pos_b[..., None], grad[1] * sl1_grad, 0.0) * w[..., None]
    return datt, dbbx


def _lib() -> ctypes.CDLL:
    from zsgnet_tpu_torch.ops.cuda import build

    lib = build.load("fused_loss")
    if not getattr(lib, "_zsg_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.zsg_match_loss_fwd.argtypes = [ptr] * 10 + [i32, i32] + [f32] * 5 + [ptr]
        lib.zsg_match_loss_fwd.restype = i32
        lib.zsg_match_loss_bwd.argtypes = [i32] + [ptr] * 10 + [i32, i32] + [f32] * 5 + [ptr]
        lib.zsg_match_loss_bwd.restype = i32
        lib._zsg_typed = True
    return lib


def _check(
    name: str, t: Tensor, shape: tuple[int, ...], dtype: torch.dtype, device: torch.device,
    vec4: bool = False,
) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if vec4 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the kernel's float4 loads")


def _check_inputs(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor, gt: Tensor, w: Tensor,
) -> tuple[int, int]:
    """Check the CUDA tensors both kernels read; → (B, A)."""
    if att.dim() != 2:
        raise ValueError(f"att must be (B, A), got shape {tuple(att.shape)}")
    b, a = att.shape
    dev = att.device
    f32 = torch.float32
    _check("att", att, (b, a), f32, dev)
    _check("bbx", bbx, (b, a, 4), f32, dev, vec4=True)
    _check("anchors_tlbr", anchors_tlbr, (a, 4), f32, dev, vec4=True)
    _check("anchors_cthw", anchors_cthw, (a, 4), f32, dev, vec4=True)
    _check("gt", gt, (b, 4), f32, dev, vec4=True)
    _check("w", w, (b,), f32, dev)
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} is outside the kernel's grid limit (1..65535)")
    return b, a


# K1's ticket counters, one int32 per (device, stream), zero between calls.
# The kernel's last cluster returns the counter to 0, so it is zeroed once.
# Calls on two streams may overlap on the card and must not draw tickets
# from one counter, hence the stream in the key.
_tickets: dict[tuple[int, int], Tensor] = {}


def _ticket(dev: torch.device, stream: int) -> Tensor:
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return _tickets[key]


def _launch_fwd(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor,
    gt: Tensor, w: Tensor, match_thr: float, neg_thr: float, alpha: float, gamma: float,
) -> tuple[Tensor, Tensor]:
    """Launch K1 on the current stream → ((3,) sums, (B,) int32 best anchors)."""
    b, a = _check_inputs(att, bbx, anchors_tlbr, anchors_cthw, gt, w)
    dev = att.device
    lib = _lib()
    partials = torch.empty((3 * b,), dtype=torch.float32, device=dev)  # scratch: each row's sums
    out = torch.empty((3,), dtype=torch.float32, device=dev)
    best = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the runtime launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zsg_match_loss_fwd(
            att.data_ptr(), bbx.data_ptr(), anchors_tlbr.data_ptr(), anchors_cthw.data_ptr(),
            gt.data_ptr(), w.data_ptr(), partials.data_ptr(), _ticket(dev, stream).data_ptr(),
            out.data_ptr(), best.data_ptr(), b, a,
            match_thr, neg_thr, alpha, gamma, BETA, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_loss forward kernel launch failed with CUDA error {err}")
    return out, best


# K2's kernels by name (csrc/fused_loss.cu, zsg_match_loss_bwd): "pos_only",
# which the backward launches, computes the box gradient at positive anchors
# only and stores 0 elsewhere; "elementwise" computes the whole closed form
# at every anchor.
BWD_VARIANTS = {"pos_only": 0, "elementwise": 1}
BWD_KERNEL = "pos_only"


def _launch_bwd(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor, gt: Tensor,
    w: Tensor, best: Tensor, grad: Tensor, match_thr: float, neg_thr: float,
    alpha: float, gamma: float, variant: str = BWD_KERNEL,
) -> tuple[Tensor, Tensor]:
    """Launch K2's kernel named ``variant`` on the current stream → (datt, dbbx)."""
    b, a = _check_inputs(att, bbx, anchors_tlbr, anchors_cthw, gt, w)
    dev = att.device
    _check("best", best, (b,), torch.int32, dev)
    _check("grad", grad, (3,), torch.float32, dev)
    datt = torch.empty_like(att)
    dbbx = torch.empty_like(bbx)  # a fresh allocation is 16-byte aligned
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.zsg_match_loss_bwd(
            BWD_VARIANTS[variant], att.data_ptr(), bbx.data_ptr(), anchors_tlbr.data_ptr(),
            anchors_cthw.data_ptr(), gt.data_ptr(), w.data_ptr(), best.data_ptr(), grad.data_ptr(),
            datt.data_ptr(), dbbx.data_ptr(), b, a,
            match_thr, neg_thr, alpha, gamma, BETA, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_loss backward kernel launch failed with CUDA error {err}")
    return datt, dbbx


def launch_bwd_variant(
    variant: str, att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor, gt: Tensor,
    w: Tensor, best: Tensor, grad: Tensor, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0,
) -> tuple[Tensor, Tensor]:
    """K2's kernel named ``variant`` (a key of ``BWD_VARIANTS``) on CUDA
    tensors, for timing the kernels side by side; counts no launch. The
    elementwise kernel gives what the JAX kernel gives on finite inputs only."""
    if variant not in BWD_VARIANTS:
        raise ValueError(f"unknown K2 kernel {variant!r}, expected one of {sorted(BWD_VARIANTS)}")
    if att.device.type != "cuda":
        raise ValueError(f"launch_bwd_variant runs a CUDA kernel, not on {att.device}")
    return _launch_bwd(att, bbx, anchors_tlbr, anchors_cthw, gt, w, best, grad.float().contiguous(),
                       match_thr, neg_thr, alpha, gamma, variant)


def _device_kind(att: Tensor) -> str:
    if att.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused loss runs on cuda or cpu, not {att.device}")
    return att.device.type


def fused_match_loss_backward(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor, gt: Tensor,
    w: Tensor, best: Tensor | None, grad: Tensor, match_thr: float = 0.5,
    neg_thr: float = 0.4, alpha: float = 0.25, gamma: float = 2.0,
) -> tuple[Tensor, Tensor]:
    """(datt, dbbx) for the upstream gradient ``grad`` (3,) of the sums.

    K2 on CUDA, where ``best`` is K1's (B,) int32 argmax anchors; the plain
    version on the CPU, which finds them itself and ignores ``best``."""
    if _device_kind(att) == "cpu":
        return fused_match_loss_backward_reference(
            att, bbx, anchors_tlbr, anchors_cthw, gt, w, grad, match_thr, neg_thr, alpha, gamma
        )
    out = _launch_bwd(att, bbx, anchors_tlbr, anchors_cthw, gt, w, best,
                      grad.float().contiguous(), match_thr, neg_thr, alpha, gamma)
    fused_match_loss_backward.launches += 1
    return out


fused_match_loss_backward.launches = 0


class FusedMatchLoss(torch.autograd.Function):
    """The fused sums with a gradient for ``att`` and ``bbx``: K1 forward and
    K2 backward on CUDA, the two plain versions on the CPU."""

    @staticmethod
    def forward(ctx, att, bbx, anchors_tlbr, anchors_cthw, gt, w, match_thr, neg_thr, alpha, gamma):
        hp = (match_thr, neg_thr, alpha, gamma)
        if _device_kind(att) == "cpu":
            out, best = fused_match_loss_reference(att, bbx, anchors_tlbr, anchors_cthw, gt, w, *hp), None
        else:
            out, best = _launch_fwd(att, bbx, anchors_tlbr, anchors_cthw, gt, w, *hp)
            fused_match_loss.launches += 1
        ctx.save_for_backward(att, bbx, anchors_tlbr, anchors_cthw, gt, w, best)
        ctx.hp = hp
        return out

    @staticmethod
    def backward(ctx, grad):
        att, bbx, anchors_tlbr, anchors_cthw, gt, w, best = ctx.saved_tensors
        datt, dbbx = fused_match_loss_backward(
            att, bbx, anchors_tlbr, anchors_cthw, gt, w, best, grad, *ctx.hp
        )
        return datt, dbbx, None, None, None, None, None, None, None, None


def fused_match_loss(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor,
    gt: Tensor, w: Tensor, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0,
) -> Tensor:
    """(3,) float32 [cls_sum, box_sum, num_pos] of the fused loss,
    differentiable in ``att`` and ``bbx``.

    att (B, A) and bbx (B, A, 4) float32 contiguous; anchors from
    :func:`pack_anchors`; gt (B, 4) tlbr; w (B,) per-sample weights (ones
    for unweighted). Kernels on CUDA, plain versions on the CPU.
    """
    return FusedMatchLoss.apply(
        att, bbx, anchors_tlbr, anchors_cthw, gt.float().contiguous(), w.float().contiguous(),
        match_thr, neg_thr, alpha, gamma,
    )


fused_match_loss.launches = 0


def zsg_loss_fused(
    att_logits: Tensor, bbx_reg: Tensor, anchors: tuple[Tensor, Tensor], gt_tlbr: Tensor, *,
    lamb_reg: float = 1.0, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0, sample_weight: Tensor | None = None,
    group=None,
) -> dict[str, Tensor]:
    """Drop-in for ``ops.losses.zsg_loss`` on the focal, multi-positive path.

    anchors: ``pack_anchors(...)``. Same return dict and normalization:
    both sums divided by the weighted positive count clamped to ≥ 1.
    With ``group`` (a process group, the JAX ``axis_name``) the count is
    summed over its ranks between K1 and the division, so each rank's
    values are partials of the global loss; K2 gets 1/count through its
    upstream gradient. ``num_pos`` stays the local count.
    """
    b = att_logits.shape[0]
    w = (
        sample_weight.float()
        if sample_weight is not None
        else torch.ones((b,), dtype=torch.float32, device=att_logits.device)
    )
    cls_sum, box_sum, num_pos_local = fused_match_loss(
        att_logits.float().contiguous(), bbx_reg.float().contiguous(), *anchors,
        gt_tlbr, w, match_thr, neg_thr, alpha, gamma,
    )
    if group is not None:
        num_pos = all_reduce_sum(num_pos_local, group).clamp(min=1.0)
    else:
        num_pos = num_pos_local.clamp(min=1.0)
    cls_ls = cls_sum / num_pos
    box_ls = box_sum / num_pos
    return {
        "total": cls_ls + lamb_reg * box_ls,
        "cls_ls": cls_ls,
        "box_ls": box_ls,
        "num_pos": num_pos_local,
    }
